"""Evaluation harness: objective VC metrics and the HTML report.

Counterpart of ``td_vc_gan_tpu/eval/``: MCD on the port's copy of the WORLD
analysis with its own exact DTW, speaker similarity with ECAPA-TDNN (or
resemblyzer when importable, else a mel-statistics embedding), predicted MOS
with MOSNet, ASR with a local Whisper checkpoint through transformers, and
the report. The models run on the CUDA card unless the caller asks for the
CPU; WORLD, the DTW and the report run on the host.
"""
