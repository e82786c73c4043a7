"""WavLM, the frozen SSL feature backbone of the content encoder, in PyTorch.

Counterpart of ``td_vc_gan_tpu/models/wavlm.py`` (sized by default for
WavLM-Large: 24 layers, width 1024, 16 heads, FFN 4096, layer norm first,
the gated T5-style relative position bias made in layer 0). Inference only:
no masking or dropout path.

Layouts. The convolutional feature extractor runs torch's ``(B, C, T)``; its
LayerNorms transpose to ``(B, T, C)`` and back around each norm (as the
Microsoft model does). :class:`WavLM` transposes the extractor's output to
``(B, T, C)`` once, and the transformer runs channels-last from there; the
positional conv transposes to ``(B, C, T)`` and back around its conv.

Parameters carry the flax names (``encoder.layer_0.self_attn.q_kernel``),
which ``weights.py`` relies on, in torch's layouts, which are the Microsoft
checkpoint's own:

- extractor conv ``conv_i``: (out, in, k);
- every ``*_kernel`` (q, k, v, out, fc1, fc2, grep, post_proj): (out, in),
  applied as ``F.linear`` (the flax kernel is (in, out));
- ``pos_conv_v``: (d, d/groups, k), weight-normed per tap (the norm over
  the first two axes, torch's ``weight_norm(dim=2)``), ``pos_conv_g``: (k,);
- ``grep_a``: (1, H, 1, 1); ``rel_attn_bias``: (num_buckets, H).

So :func:`load_wavlm_checkpoint` copies the Microsoft ``.pt``'s tensors as
they are, only renamed (and ``weight_g`` flattened), and
:func:`backbone_digest` hashes the same bytes in the file and in the model.

Precision. ``WavLMConfig.compute_dtype = "bfloat16"`` runs the backbone as
the JAX package's does: the wav is cast to bf16 on entry, every conv and
``F.linear`` takes its f32 weights cast to the activation's dtype on each
call (no bf16 copy is kept, so the weights and their digest stay the f32
ones), LayerNorm and GroupNorm compute in f32 and cast back, the attention
scores and softmax are f32 and the probabilities bf16, and the output is
cast to f32. In f32 every cast is a no-op.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import math
from collections.abc import Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch.models.layers import conv1d


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    # WavLM-Large defaults (the Microsoft WavLM.py:162-214 and the Large
    # checkpoint's cfg)
    extractor_mode: str = "layer_norm"  # 'default' (Base) | 'layer_norm' (Large)
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    layer_norm_first: bool = True
    conv_feature_layers: tuple = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2
    conv_bias: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    # 'bfloat16': bf16 conv and matmul inputs and activations (see the
    # module's docstring); None or 'float32': f32
    compute_dtype: str | None = None

    @property
    def total_stride(self) -> int:
        s = 1
        for _, _, stride in self.conv_feature_layers:
            s *= stride
        return s  # 320 => 50 Hz frames at 16 kHz


def _dt(cfg: WavLMConfig) -> torch.dtype | None:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _as(t: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor | None:
    """A weight cast to the activation's dtype (a no-op in f32)."""
    return None if t is None else t.to(like.dtype)


def wavlm_base_config() -> WavLMConfig:
    return WavLMConfig(
        extractor_mode="default", encoder_layers=12, encoder_embed_dim=768,
        encoder_ffn_embed_dim=3072, encoder_attention_heads=12,
        layer_norm_first=False, max_distance=800,
    )


def _xavier_(t: torch.Tensor, gen: torch.Generator) -> None:
    """Glorot uniform for an (out, in) kernel."""
    fan_out, fan_in = t.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * limit)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


class _LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis (channels), in float32, eps 1e-5,
    cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps).to(x.dtype)


class _GroupNorm(_LayerNorm):
    """Affine GroupNorm(d, d) in float32, eps 1e-5: each channel normalised
    over time. Input (B, C, T). Used only by the 'default' extractor's
    layer 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), x.shape[1], self.scale, self.bias, self.eps).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Strided conv front end, (B, T) wav -> (B, 512, T / 320), no padding.
    After each conv: a LayerNorm over channels ('layer_norm' mode) or, in
    'default' mode, a GroupNorm after layer 0 only; then exact GELU."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        cin = 1
        for i, (dim, k, _) in enumerate(cfg.conv_feature_layers):
            self.register_parameter(f"conv_{i}", nn.Parameter(torch.empty(dim, cin, k)))
            if cfg.conv_bias:
                self.register_parameter(f"conv_{i}_bias", nn.Parameter(torch.zeros(dim)))
            if cfg.extractor_mode == "layer_norm":
                self.add_module(f"ln_{i}", _LayerNorm(dim))
            elif i == 0:
                self.gn_0 = _GroupNorm(dim)
            cin = dim

    def reset_parameters(self, gen: torch.Generator) -> None:
        for i, _ in enumerate(self.cfg.conv_feature_layers):
            w = getattr(self, f"conv_{i}")
            _normal_(w, math.sqrt(2.0 / (w.shape[1] * w.shape[2])), gen)  # He normal
            if self.cfg.conv_bias:
                getattr(self, f"conv_{i}_bias").data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        for i, (_, _, stride) in enumerate(self.cfg.conv_feature_layers):
            h = conv1d(h, _as(getattr(self, f"conv_{i}"), h),
                       _as(getattr(self, f"conv_{i}_bias", None), h), stride=stride)
            if self.cfg.extractor_mode == "layer_norm":
                h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                h = self.gn_0(h)
            h = F.gelu(h, approximate="none")
        return h


def _relative_position_buckets(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 bidirectional bucket map (the Microsoft modules.py:421-446), on the
    host with numpy: (n, n) int64."""
    ctx = np.arange(n)[:, None]
    mem = np.arange(n)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


class MultiheadAttention(nn.Module):
    """Self-attention with the gated relative position bias. Input (B, T, D);
    returns (out, position_bias). Layer 0 (``has_relative_attention_bias``)
    makes the (H, T, T) bias from its bucket table; every later layer
    reuses it, gated by its own queries."""

    def __init__(self, cfg: WavLMConfig, has_relative_attention_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        self.has_relative_attention_bias = has_relative_attention_bias
        for name in ("q", "k", "v", "out"):
            self.register_parameter(f"{name}_kernel", nn.Parameter(torch.empty(d, d)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(d)))
        if has_relative_attention_bias:
            self.rel_attn_bias = nn.Parameter(torch.empty(cfg.num_buckets, h))
        # the gates exist where a position bias does: in every layer when
        # layer 0 makes one
        self.gated = cfg.gru_rel_pos and cfg.relative_position_embedding
        if self.gated:
            self.grep_kernel = nn.Parameter(torch.empty(8, d // h))
            self.grep_bias = nn.Parameter(torch.zeros(8))
            self.grep_a = nn.Parameter(torch.ones(1, h, 1, 1))
        self._buckets: dict = {}  # (T, device) -> the (T, T) bucket index

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("q", "k", "v", "out"):
            _xavier_(getattr(self, f"{name}_kernel"), gen)
            getattr(self, f"{name}_bias").data.zero_()
        if self.has_relative_attention_bias:
            _normal_(self.rel_attn_bias, 0.02, gen)
        if self.gated:
            _xavier_(self.grep_kernel, gen)
            self.grep_bias.data.zero_()
            self.grep_a.data.fill_(1.0)

    def buckets(self, t: int, device) -> torch.Tensor:
        key = (t, str(device))
        if key not in self._buckets:
            c = self.cfg
            self._buckets[key] = torch.from_numpy(
                _relative_position_buckets(t, c.num_buckets, c.max_distance)).to(device)
        return self._buckets[key]

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor | None = None):
        c = self.cfg
        b, t, d = x.shape
        h = c.encoder_attention_heads
        dh = d // h

        def proj(name, y):
            return F.linear(y, _as(getattr(self, f"{name}_kernel"), y),
                            _as(getattr(self, f"{name}_bias"), y))

        q, k, v = (proj(name, x).reshape(b, t, h, dh).transpose(1, 2) for name in "qkv")

        if self.has_relative_attention_bias and position_bias is None:
            position_bias = self.rel_attn_bias[self.buckets(t, x.device)].permute(2, 0, 1)

        bias = None
        if position_bias is not None:
            bias = position_bias[None]  # (1, H, T, T)
            if self.gated:
                # gates from the unscaled queries (modules.py:523-533)
                gates = torch.sigmoid(F.linear(q, _as(self.grep_kernel, q), _as(self.grep_bias, q))
                                      .reshape(b, h, t, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
                bias = (gate_a * (gate_b * self.grep_a - 1.0) + 2.0) * bias  # (B, H, T, T)

        # scores and softmax in f32 (exact products of bf16 q and k), the
        # probabilities in the activations' dtype
        scores = torch.matmul((q * dh ** -0.5).float(), k.float().transpose(-1, -2))
        if bias is not None:
            scores = scores + bias
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        return proj("out", out), position_bias


class EncoderLayer(nn.Module):
    """Transformer layer, LayerNorm before (``layer_norm_first``) or after
    each block."""

    def __init__(self, cfg: WavLMConfig, has_relative_attention_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
        self.self_attn = MultiheadAttention(cfg, has_relative_attention_bias)
        self.self_attn_layer_norm = _LayerNorm(d)
        self.final_layer_norm = _LayerNorm(d)
        self.fc1_kernel = nn.Parameter(torch.empty(f, d))
        self.fc1_bias = nn.Parameter(torch.zeros(f))
        self.fc2_kernel = nn.Parameter(torch.empty(d, f))
        self.fc2_bias = nn.Parameter(torch.zeros(d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _xavier_(self.fc1_kernel, gen)
        _xavier_(self.fc2_kernel, gen)
        self.fc1_bias.data.zero_()
        self.fc2_bias.data.zero_()

    def ffn(self, y: torch.Tensor) -> torch.Tensor:
        y = F.gelu(F.linear(y, _as(self.fc1_kernel, y), _as(self.fc1_bias, y)),
                   approximate="none")
        return F.linear(y, _as(self.fc2_kernel, y), _as(self.fc2_bias, y))

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor | None = None):
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.cfg.layer_norm_first:
            a, position_bias = self.self_attn(ln1(x), position_bias)
            x = x + a
            x = x + self.ffn(ln2(x))
        else:
            a, position_bias = self.self_attn(x, position_bias)
            x = ln1(x + a)
            x = ln2(x + self.ffn(x))
        return x, position_bias


class TransformerEncoder(nn.Module):
    """Conv positional embedding, then the layer stack; (B, T, D) in and out.

    ``pos_conv``: a grouped conv of k = ``conv_pos`` taps, padded k // 2 on
    each side, its weight normed per tap; for even k the last frame is
    dropped (SamePad); the encoder adds gelu(pos) to its input."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        d, k, g = cfg.encoder_embed_dim, cfg.conv_pos, cfg.conv_pos_groups
        self.pos_conv_v = nn.Parameter(torch.empty(d, d // g, k))
        self.pos_conv_g = nn.Parameter(torch.ones(k))
        self.pos_conv_bias = nn.Parameter(torch.zeros(d))
        self.layer_norm = _LayerNorm(d)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg, has_relative_attention_bias=cfg.relative_position_embedding and i == 0))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.pos_conv_v, 0.02, gen)
        self.pos_conv_g.data.fill_(1.0)
        self.pos_conv_bias.data.zero_()

    def pos_conv_weight(self) -> torch.Tensor:
        """g * v / max(||v||, 1e-12), the norm taken per tap (over the
        output and input channels)."""
        v = self.pos_conv_v
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
        return v * (self.pos_conv_g.reshape(1, 1, -1) / torch.clamp_min(norm, 1e-12))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        k = c.conv_pos
        pos = conv1d(x.transpose(1, 2), _as(self.pos_conv_weight(), x),
                     _as(self.pos_conv_bias, x), padding=k // 2, groups=c.conv_pos_groups)
        if k % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos, approximate="none").transpose(1, 2)
        if not c.layer_norm_first:
            x = self.layer_norm(x)
        position_bias = None
        for i in range(c.encoder_layers):
            x, position_bias = getattr(self, f"layer_{i}")(x, position_bias)
        if c.layer_norm_first:
            x = self.layer_norm(x)
        return x


class WavLM(nn.Module):
    """(B, T) wav -> (B, T // 320, encoder_embed_dim) features: extractor,
    post-extract LayerNorm, projection to the encoder's width, encoder; f32
    features in either compute dtype."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        c_ext, d = cfg.conv_feature_layers[-1][0], cfg.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.post_extract_layer_norm = _LayerNorm(c_ext)
        if c_ext != d:
            self.post_proj_kernel = nn.Parameter(torch.empty(d, c_ext))
            self.post_proj_bias = nn.Parameter(torch.zeros(d))
        self.encoder = TransformerEncoder(cfg)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if hasattr(self, "post_proj_kernel"):
            _xavier_(self.post_proj_kernel, gen)
            self.post_proj_bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dt(self.cfg)
        if dt is not None:
            x = x.to(dt)
        feats = self.post_extract_layer_norm(self.feature_extractor(x).transpose(1, 2))
        if hasattr(self, "post_proj_kernel"):
            feats = F.linear(feats, _as(self.post_proj_kernel, feats),
                             _as(self.post_proj_bias, feats))
        out = self.encoder(feats)
        return out.float() if dt is not None else out


# ---------------------------------------------------------------------------
# the Microsoft checkpoint
# ---------------------------------------------------------------------------

# In a Microsoft WavLM .pt but not read: the masking embedding of pretraining.
_UNUSED_KEYS = frozenset({"mask_emb"})


def key_table(cfg: WavLMConfig) -> list[tuple[str, str]]:
    """(Microsoft state-dict key, the port's parameter name) of every tensor
    of a WavLM with ``cfg``, in the port's module order."""
    t = []
    for i in range(len(cfg.conv_feature_layers)):
        ms = f"feature_extractor.conv_layers.{i}"
        t.append((f"{ms}.0.weight", f"feature_extractor.conv_{i}"))
        if cfg.conv_bias:
            t.append((f"{ms}.0.bias", f"feature_extractor.conv_{i}_bias"))
        if cfg.extractor_mode == "layer_norm":
            t += [(f"{ms}.2.1.weight", f"feature_extractor.ln_{i}.scale"),
                  (f"{ms}.2.1.bias", f"feature_extractor.ln_{i}.bias")]
        elif i == 0:
            t += [(f"{ms}.2.weight", "feature_extractor.gn_0.scale"),
                  (f"{ms}.2.bias", "feature_extractor.gn_0.bias")]
    t += [("layer_norm.weight", "post_extract_layer_norm.scale"),
          ("layer_norm.bias", "post_extract_layer_norm.bias")]
    if cfg.conv_feature_layers[-1][0] != cfg.encoder_embed_dim:
        t += [("post_extract_proj.weight", "post_proj_kernel"),
              ("post_extract_proj.bias", "post_proj_bias")]
    t += [("encoder.pos_conv.0.weight_v", "encoder.pos_conv_v"),
          ("encoder.pos_conv.0.weight_g", "encoder.pos_conv_g"),
          ("encoder.pos_conv.0.bias", "encoder.pos_conv_bias"),
          ("encoder.layer_norm.weight", "encoder.layer_norm.scale"),
          ("encoder.layer_norm.bias", "encoder.layer_norm.bias")]
    for i in range(cfg.encoder_layers):
        ms, ours = f"encoder.layers.{i}", f"encoder.layer_{i}"
        for name in ("q", "k", "v", "out"):
            t += [(f"{ms}.self_attn.{name}_proj.weight", f"{ours}.self_attn.{name}_kernel"),
                  (f"{ms}.self_attn.{name}_proj.bias", f"{ours}.self_attn.{name}_bias")]
        if cfg.relative_position_embedding and i == 0:
            t.append((f"{ms}.self_attn.relative_attention_bias.weight",
                      f"{ours}.self_attn.rel_attn_bias"))
        if cfg.gru_rel_pos and cfg.relative_position_embedding:
            t += [(f"{ms}.self_attn.grep_linear.weight", f"{ours}.self_attn.grep_kernel"),
                  (f"{ms}.self_attn.grep_linear.bias", f"{ours}.self_attn.grep_bias"),
                  (f"{ms}.self_attn.grep_a", f"{ours}.self_attn.grep_a")]
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            t += [(f"{ms}.{ln}.weight", f"{ours}.{ln}.scale"),
                  (f"{ms}.{ln}.bias", f"{ours}.{ln}.bias")]
        for fc in ("fc1", "fc2"):
            t += [(f"{ms}.{fc}.weight", f"{ours}.{fc}_kernel"),
                  (f"{ms}.{fc}.bias", f"{ours}.{fc}_bias")]
    return t


def _conv_layers(text: str) -> tuple:
    """``conv_feature_layers`` as the Microsoft cfg writes it, e.g.
    ``"[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"``: list literals
    (``ast.literal_eval``) joined by ``+`` and repeated by an int ``*``;
    anything else raises."""

    def value(node):
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mult)):
            a, b = value(node.left), value(node.right)
            if isinstance(node.op, ast.Add) and isinstance(a, list) and isinstance(b, list):
                return a + b
            if isinstance(node.op, ast.Mult) and isinstance(a, list) and type(b) is int:
                return a * b
            raise ValueError(f"conv_feature_layers: cannot evaluate {text!r}")
        return ast.literal_eval(node)

    layers = value(ast.parse(text.strip(), mode="eval").body)
    return tuple(tuple(int(v) for v in layer) for layer in layers)


def load_wavlm_checkpoint(path) -> tuple[WavLMConfig, dict[str, torch.Tensor]]:
    """A Microsoft WavLM ``.pt`` (``cfg`` and ``model``) -> (config, state
    dict of the port's :class:`WavLM` under its names, CPU tensors), for
    ``WavLM(cfg).load_state_dict``. A key of the table that the file lacks,
    or a key of the file outside the table (and outside ``mask_emb``),
    raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    fields = {f.name for f in dataclasses.fields(WavLMConfig)}
    kwargs = {k: v for k, v in ckpt["cfg"].items() if k in fields}
    if isinstance(kwargs.get("conv_feature_layers"), str):
        kwargs["conv_feature_layers"] = _conv_layers(kwargs["conv_feature_layers"])
    elif "conv_feature_layers" in kwargs:
        kwargs["conv_feature_layers"] = tuple(tuple(t) for t in kwargs["conv_feature_layers"])
    cfg = WavLMConfig(**kwargs)
    sd = ckpt["model"]
    table = key_table(cfg)
    missing = [ms for ms, _ in table if ms not in sd]
    extra = sorted(set(sd) - {ms for ms, _ in table} - _UNUSED_KEYS)
    if missing or extra:
        raise KeyError(f"{path}: not a WavLM checkpoint of its cfg: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    state = {}
    for ms, ours in table:
        t = sd[ms].detach().to(torch.float32)
        state[ours] = t.reshape(-1) if ours == "encoder.pos_conv_g" else t
    return cfg, state


def backbone_digest(tensors: Iterable[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes (float32), in the order given."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().to(torch.float32).cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def wavlm_digest(model: WavLM) -> str:
    """:func:`backbone_digest` of a WavLM's tensors in :func:`key_table`
    order: equal to that of a Microsoft file's ``model`` tensors in the same
    order exactly when the model holds that file's weights bit for bit."""
    sd = model.state_dict()
    return backbone_digest(sd[ours] for _, ours in key_table(model.cfg))
