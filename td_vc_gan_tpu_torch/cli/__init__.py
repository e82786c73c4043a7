"""Command-line entry points of the port (``python -m td_vc_gan_tpu_torch.cli.<name>``)."""
