"""Vision Transformer and its V-MoE variant, the port of
deep_vision_tpu/models/vit.py: `Attention`, `Mlp`, `MoeMlp`, `ViTBlock`,
`ViT`, `vit_s16`, `vit_b16` and `vmoe_s16`.

NHWC images in, f32 logits out, as the JAX model. Patch embedding is one
stride-P convolution (`F.conv2d`, as XLA computes it), its (h, w) grid
flattened row-major into T tokens; a learned `pos_embed` (1, T, dim);
pre-norm blocks (LayerNorm, attention, residual; LayerNorm, GELU MLP,
residual); a final LayerNorm in f32, the token mean and an f32 classifier.
`dtype` is the blocks' compute dtype (bf16 over f32 parameters in the
training configuration); LayerNorm statistics run in f32 and cast back.

Two things differ from the JAX module's construction:

- flax creates `pos_embed` from the first input; here its length comes
  from `image_size` (default 224), and an input of another size raises.
- `nn.gelu` is flax's tanh approximation; `F.gelu` is called with
  `approximate="tanh"` to match it.

Attention routes as vit.py:64-68 does: the flash kernels
(`ops/cuda/flash_attention.py`) when T >= `flash_min_tokens()` and
T % 1024 == 0, the dense einsum otherwise. The reference also requires
`pallas_compiled`; here the op picks kernel or plain version by device,
so a CPU model at T = 1024 runs the plain flash path. The `% 1024` clause
is the TPU kernel's block grid, which the Hopper kernels do not need
(they take any T); it stays so that the port routes as the reference.

Submodules carry the flax names (`patch_embed`, `ViTBlock_<i>`,
`LayerNorm_0`, `Attention_0`, `qkv`, `out`, `Mlp_0`, `Dense_0`, ...), so
state_dict keys are the reference's variable paths (convert.py).
`remat=True` recomputes each block in the backward
(`torch.utils.checkpoint`, non-reentrant), as `nn.remat` does.
`dropout` > 0 adds a `Dropout` after the position embedding, active in
training mode only (the Trainer seeds its masks a step).

V-MoE (`num_experts` > 0): every `moe_every`-th block, counting from
block `moe_every - 1`, replaces its MLP by `MoeMlp`, a top-1 Switch MLP
(vit.py:96-145). The reference dispatches densely: a one-hot einsum runs
every token through all E experts and keeps the chosen one, adding exact
zeros for the rest. The port computes the same sum by grouping tokens by
expert: a stable sort by choice, one `torch.matmul` a group, and the
rows put back by an inverse-permutation gather, whose backward writes
each row once, so a step is repeatable bitwise on the card. Reading the
group sizes costs one host sync a MoE block. In training mode the ViT
then returns `(logits, {"moe_aux", "_router_entropy",
"_expert_load_max"})` as the reference does (:227-248): the Switch
load-balancing loss averaged over the MoE blocks, which
`classification_loss_fn` adds at its `penalty_weight`, and the router's
mean gate entropy and largest expert share, metrics only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    Dense,
    DenseGeneral,
    Dropout,
    LayerNorm,
    flax_cast,
    trunc_normal_fan_in_,
)
from deep_vision_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_min_tokens,
)
from deep_vision_tpu_torch.parallel.moe import load_balancing_loss


def use_flash(t: int) -> bool:
    """The reference's routing rule (vit.py:64-68) for T tokens."""
    return t >= flash_min_tokens() and t % 1024 == 0


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = DenseGeneral(dim, (3, num_heads, head_dim), dtype=dtype)
        self.out = DenseGeneral((num_heads, head_dim), dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        # q, k, v: strided (B, T, H, Dh) views of the (B, T, 3, H, Dh)
        # projection, which the flash kernels read in place
        q, k, v = self.qkv(x).unbind(2)
        if use_flash(t):
            o = flash_attention(q, k, v)
        else:
            scale = (d // self.num_heads) ** -0.5
            s = torch.einsum("bthd,bshd->bhts", q, k) * scale
            p = torch.softmax(s.float(), dim=-1).to(q.dtype)
            o = torch.einsum("bhts,bshd->bthd", p, v)
        return self.out(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class MoeMlp(nn.Module):
    """Top-1 Switch MLP over E experts (vit.py:96-145). The router is a
    float32 (dim, E) matrix and the softmax runs over float32 logits;
    each token goes to its arg-max expert (`choose`), whose output is
    scaled by that gate. Expert weights keep the reference's stacked
    layout, `w1` (E, dim, hidden), `b1` (E, hidden), `w2` (E, hidden,
    dim), `b2` (E, dim), so convert.py maps them one to one. Returns
    (out (B, T, dim), gates (B * T, E) float32)."""

    def __init__(self, dim: int, num_experts: int, hidden: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(dim, num_experts))
        self.w1 = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's lecun_normal for the router and the expert kernels, zero
        biases. flax counts a 3-D kernel's leading axis into its fan:
        fan_in = E * dim for `w1`, E * hidden for `w2`."""
        with torch.no_grad():
            for w in (self.router, self.w1, self.w2):
                fan_in = w.shape[-2] * (w.shape[0] if w.dim() == 3 else 1)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            self.b1.zero_()
            self.b2.zero_()

    def choose(self, gates: torch.Tensor) -> torch.Tensor:
        """Each token's expert: the arg-max of its gates, the first index
        on a tie (as jnp.argmax)."""
        return gates.argmax(dim=-1)

    def forward(self, x: torch.Tensor):
        b, t, d = x.shape
        e = self.router.shape[1]
        dt = self.dtype or x.dtype
        tok = x.reshape(b * t, d)
        gates = torch.softmax(tok.float() @ self.router, dim=-1)
        choice = self.choose(gates)
        prob = gates.gather(1, choice[:, None])
        order = torch.argsort(choice, stable=True)
        sizes = torch.bincount(choice, minlength=e).tolist()
        groups = tok.to(dt)[order].split(sizes)
        outs = []
        for i, xi in enumerate(groups):
            h = F.gelu(torch.matmul(xi, self.w1[i].to(dt))
                       + self.b1[i].to(dt), approximate="tanh")
            outs.append(torch.matmul(h, self.w2[i].to(dt))
                        + self.b2[i].to(dt))
        # back to token order: a gather by the inverse permutation
        inverse = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        out = torch.cat(outs)[inverse] * prob.to(dt)
        return out.reshape(b, t, d), gates


class ViTBlock(nn.Module):
    """Pre-norm block; with `num_experts` its MLP is a `MoeMlp` and it
    returns (x, gates), else x."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 num_experts: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=torch.float32)
        self.Attention_0 = Attention(dim, num_heads, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=torch.float32)
        if num_experts:
            self.MoeMlp_0 = MoeMlp(dim, num_experts, dim * mlp_ratio,
                                   dtype=dtype)
        else:
            self.Mlp_0 = Mlp(dim, dim * mlp_ratio, dtype=dtype)

    def forward(self, x: torch.Tensor):
        # `LayerNorm(dtype=f32)(x).astype(x.dtype)` in the reference: the
        # f32 result rounded once to x's dtype, by the kernel itself
        x = x + self.Attention_0(self.LayerNorm_0(x, out_dtype=x.dtype))
        y = self.LayerNorm_1(x, out_dtype=x.dtype)
        if hasattr(self, "MoeMlp_0"):
            y, gates = self.MoeMlp_0(y)
            return x + y, gates
        return x + self.Mlp_0(y)


class ViT(nn.Module):
    """ViT classifier. Input NHWC (B, image_size, image_size, 3); output
    (B, num_classes) f32 logits, with V-MoE's aux dict in training mode
    (the module docstring)."""

    def __init__(self, depth: int = 12, dim: int = 384, num_heads: int = 6,
                 patch: int = 16, num_classes: int = 1000,
                 mlp_ratio: int = 4, image_size: int = 224,
                 in_channels: int = 3, num_experts: int = 0,
                 moe_every: int = 2, dropout: float = 0.0,
                 remat: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch}")
        self.depth, self.dim, self.patch = depth, dim, patch
        self.image_size, self.remat, self.dtype = image_size, remat, dtype
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        if dropout:
            self.Dropout_0 = Dropout(dropout)
        for i in range(depth):
            moe = (num_experts if num_experts
                   and i % moe_every == moe_every - 1 else 0)
            setattr(self, f"ViTBlock_{i}",
                    ViTBlock(dim, num_heads, mlp_ratio, num_experts=moe,
                             dtype=dtype))
        self.LayerNorm_0 = LayerNorm(dim, dtype=torch.float32)
        self.Dense_0 = Dense(dim, num_classes, dtype=torch.float32)

    def forward(self, images: torch.Tensor):
        b, hh, ww, _ = images.shape
        if (hh, ww) != (self.image_size, self.image_size):
            raise ValueError(f"image {hh}x{ww}: this ViT was built for "
                             f"{self.image_size}x{self.image_size} "
                             f"(pos_embed has its token count)")
        dt = self.dtype or images.dtype
        x, w = flax_cast(images.permute(0, 3, 1, 2), self.patch_embed.weight,
                         dt)
        x = F.conv2d(x, w, stride=self.patch)
        x = x + self.patch_embed.bias.to(x.dtype).view(1, -1, 1, 1)
        x = x.flatten(2).transpose(1, 2)  # (B, T, dim), (h, w) row-major
        x = x + self.pos_embed.to(x.dtype)
        if hasattr(self, "Dropout_0"):
            x = self.Dropout_0(x)
        all_gates = []
        for i in range(self.depth):
            block = getattr(self, f"ViTBlock_{i}")
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x)
            if isinstance(x, tuple):
                x, gates = x
                all_gates.append(gates)
        x = self.LayerNorm_0(x.float()).mean(dim=1)  # token-mean pool
        logits = self.Dense_0(x)
        if not (self.training and all_gates):
            return logits
        gates = torch.stack(all_gates)  # (L, B * T, E)
        aux = torch.stack([load_balancing_loss(g) for g in all_gates]).mean()
        entropy = -(gates * torch.log(gates + 1e-9)).sum(dim=-1)
        top1 = F.one_hot(gates.argmax(dim=-1), gates.shape[-1]).float()
        return logits, {"moe_aux": aux,
                        "_router_entropy": entropy.mean(),
                        "_expert_load_max": top1.mean(dim=1).max()}


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Draw every weight as flax initializes it, in module order from
    `generator`: the patch conv, the DenseGenerals and Denses
    lecun-normal over their fan-in with zero biases, `pos_embed` from
    normal(0.02), LayerNorms at scale 1 and bias 0, each MoeMlp by its
    own `reset_parameters`."""
    for m in model.modules():
        if isinstance(m, (DenseGeneral, MoeMlp)):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            m.reset_parameters()
        elif isinstance(m, ViT):
            with torch.no_grad():
                trunc_normal_fan_in_(m.patch_embed.weight, 1.0, generator)
                m.patch_embed.bias.zero_()
                m.pos_embed.normal_(0.0, 0.02, generator=generator)


@register_model("vit_s16", init=reset_parameters)
def vit_s16(num_classes: int = 1000, dtype=None, remat: bool = False,
            image_size: int = 224, **_):
    return ViT(depth=12, dim=384, num_heads=6, num_classes=num_classes,
               image_size=image_size, remat=remat, dtype=dtype)


@register_model("vit_b16", init=reset_parameters)
def vit_b16(num_classes: int = 1000, dtype=None, remat: bool = False,
            image_size: int = 224, **_):
    return ViT(depth=12, dim=768, num_heads=12, num_classes=num_classes,
               image_size=image_size, remat=remat, dtype=dtype)


@register_model("vmoe_s16", init=reset_parameters)
def vmoe_s16(num_classes: int = 1000, dtype=None, num_experts: int = 8,
             remat: bool = False, image_size: int = 224, **_):
    return ViT(depth=12, dim=384, num_heads=6, num_classes=num_classes,
               num_experts=num_experts, image_size=image_size, remat=remat,
               dtype=dtype)
