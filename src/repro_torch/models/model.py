"""Model configuration.

Every registered architecture is a :class:`ModelConfig` with the fields and
values of the JAX package's ``repro/models/model.py``; ``dtype`` is a
``torch.dtype``.  ``build()`` returns the family module that exposes
``init_params``/``forward``/``prefill``/``decode_step``: the transformer
for the dense and MoE families, Mamba2 for the SSM family and Zamba2 for
the hybrid one, as in JAX.  Layers run in a Python loop: there is no scan
to switch to full unroll.

A family's parameters are a dict whose stacks (``STACKS``: JAX's stacked
(L, ...) subtrees) are lists of per-layer dicts; every other value is a
tensor or, for Zamba2's ``shared_attn``, a dict of tensors.  Shape trees
have the same structure with shape tuples for tensors.
"""
from __future__ import annotations

import dataclasses
import math

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

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline accounting)."""
        return sum(math.prod(s) for s in tree_leaves(self.param_shapes()))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.kind != "moe":
            return self.param_count()
        total = self.param_count()
        moe_layers = self.n_layers - self.dense_layers
        expert_params = moe_layers * self.n_experts * (
            (2 if self.activation not in ("swiglu", "geglu") else 3)
            * self.d_model * self.d_ff
        )
        active_expert = expert_params * (self.top_k + self.n_shared_experts) / self.n_experts
        return int(total - expert_params + active_expert)

    def param_shapes(self) -> dict:
        return self.build().param_shapes(self)

    def build(self):
        """Return the family module exposing init/prefill/decode fns."""
        from . import mamba2, transformer, zamba2

        return {"dense": transformer, "moe": transformer,
                "ssm": mamba2, "hybrid": zamba2}[self.kind]


# the per-layer stacks of a family's parameters, in the order they run
STACKS = ("dense_layers", "layers", "mamba")


def tree_map(fn, tree):
    """``fn`` over the leaves of a parameter or shape tree (lists and dicts
    kept; a leaf is anything else, a shape tuple included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``init_by_rule``'s order: dict keys sorted,
    list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def cut_depth(cfg: ModelConfig, params: dict, depth: int):
    """(cfg, params) of the model's first ``depth`` layers: the stacks cut
    in the order they run (an MoE's leading dense layers first), every
    other leaf shared."""
    out, left = dict(params), depth
    for k in STACKS:
        if k in params:
            out[k] = params[k][:left]
            left -= len(out[k])
    kw = {"n_layers": depth}
    if cfg.kind == "moe":
        kw["dense_layers"] = min(cfg.dense_layers, depth)
    return dataclasses.replace(cfg, **kw), out


def shapes_to_struct(shapes: dict, dtype, float32_leaves: frozenset = frozenset()):
    """A shape tree as uninitialised tensors (FakeTensors under the active
    ``FakeTensorMode``: the dry-run's stand-ins), each in ``dtype`` but the
    leaves named in ``float32_leaves`` (the family's ``FLOAT32_LEAVES``),
    which stay float32 as ``init_by_rule`` keeps them."""
    def make(tree, name=None):
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [make(v, name) for v in tree]
        return torch.empty(tree, dtype=torch.float32 if name in float32_leaves else dtype)

    return make(shapes)


def init_by_rule(cfg: ModelConfig, shapes: dict, generator: "torch.Generator | int" = 0,
                 device="cuda") -> dict:
    """Random parameters of a family's ``shapes`` with the JAX package's
    rule: every matrix normal with std fan_in ** -0.5 (fan_in =
    shape[-2]), every vector zero (norm weights 0 scale by 1).  JAX's init
    sees a per-layer vector stacked to (L, D) as a matrix and draws it with
    std L ** -0.5; the port keeps it zero (ROADMAP Queue 3).  Drawn in f32
    from ``generator`` (or a seed) on the generator's device, leaf by leaf
    in ``tree_leaves`` order, so one seed and generator device give the
    same weights on every ``device``; then cast to ``cfg.dtype`` (the
    family's ``FLOAT32_LEAVES`` stay float32) on ``device``.  A CPU
    generator is the default; a CUDA one draws a model of billions of
    parameters in seconds."""
    dev = resolve_device(device)
    gen = generator if isinstance(generator, torch.Generator) \
        else torch.Generator().manual_seed(int(generator))
    f32_leaves = cfg.build().FLOAT32_LEAVES

    def draw(tree, name=None):
        if isinstance(tree, dict):
            return {k: draw(tree[k], k) for k in sorted(tree)}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        if len(tree) >= 2:
            w = torch.randn(tree, generator=gen, dtype=torch.float32,
                            device=gen.device) * tree[-2] ** -0.5
        else:
            w = torch.zeros(tree, dtype=torch.float32)
        return w.to(device=dev, dtype=torch.float32 if name in f32_leaves else cfg.dtype)

    return draw(shapes)
