"""Model configuration.

Every registered architecture is a :class:`ModelConfig` with the fields and
values of the JAX package's ``repro/models/model.py``; ``dtype`` is a
``torch.dtype``.  ``build()`` returns the family module that exposes
``init_params``/``forward``/``prefill``/``decode_step``.  The port has the
dense transformer so far; the MoE, SSM and hybrid families are still to
port (ROADMAP Queue 1 item 8).  Layers run in a Python loop: there is no
scan to switch to full unroll.
"""
from __future__ import annotations

import dataclasses

import torch


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
        if self.kind != "dense":
            raise NotImplementedError(
                f"{self.name}: the {self.kind!r} family is not ported yet "
                "(ROADMAP.md, Queue 1 item 8); the port has the dense transformer")
        from . import transformer

        return transformer
