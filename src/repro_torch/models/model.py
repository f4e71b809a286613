"""Model configuration.

Every registered architecture is a :class:`ModelConfig` with the fields and
values of the JAX package's ``repro/models/model.py``; ``dtype`` is a
``torch.dtype``.  ``build()`` returns the family module that exposes
``init_params``/``forward``/``prefill``/``decode_step``.  The port has the
dense transformer and the SSM family (Mamba2) so far; the MoE and hybrid
families are still to port (ROADMAP Queue 1 item 5).  Layers run in a
Python loop: there is no scan to switch to full unroll.
"""
from __future__ import annotations

import dataclasses

import torch

from ..olap.columnar import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str  # 'dense' | 'moe' | 'ssm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # chatglm-style partial rotary ("RoPE 2d")
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    dense_layers: int = 0  # leading dense layers before MoE stack (kimi-style)
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    attn_every: int = 0  # zamba: one shared attention block every N mamba layers
    conv_kernel: int = 4
    # modality stub: prefill consumes precomputed frame/patch embeddings
    embed_inputs: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_shapes(self) -> dict:
        return self.build().param_shapes(self)

    def build(self):
        """Return the family module exposing init/prefill/decode fns."""
        if self.kind not in ("dense", "ssm"):
            raise NotImplementedError(
                f"{self.name}: the {self.kind!r} family is not ported yet "
                "(ROADMAP.md, Queue 1 item 5); the port has the dense transformer "
                "and Mamba2")
        from . import mamba2, transformer

        return {"dense": transformer, "ssm": mamba2}[self.kind]


def init_by_rule(cfg: ModelConfig, shapes: dict, generator: "torch.Generator | int" = 0,
                 device="cuda") -> dict:
    """Random parameters of a family's ``shapes`` with the JAX package's
    rule: every matrix normal with std fan_in ** -0.5 (fan_in =
    shape[-2]), every vector zero (norm weights 0 scale by 1).  JAX's init
    sees a per-layer vector stacked to (L, D) as a matrix and draws it with
    std L ** -0.5; the port keeps it zero (ROADMAP Queue 3).  Drawn in f32
    on the CPU from ``generator`` (or a seed), so one seed gives the same
    weights on every device; then cast to ``cfg.dtype`` on ``device``."""
    dev = resolve_device(device)
    gen = generator if isinstance(generator, torch.Generator) \
        else torch.Generator().manual_seed(int(generator))

    def leaf(shape):
        if len(shape) >= 2:
            w = torch.randn(shape, generator=gen, dtype=torch.float32) * shape[-2] ** -0.5
        else:
            w = torch.zeros(shape, dtype=torch.float32)
        return w.to(device=dev, dtype=cfg.dtype)

    return {k: ([{n: leaf(s) for n, s in sorted(lp.items())} for lp in v]
                if k == "layers" else leaf(v))
            for k, v in sorted(shapes.items())}
