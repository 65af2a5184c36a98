"""Vision Transformer, the port of the dense half of
deep_vision_tpu/models/vit.py: `Attention`, `Mlp`, `ViTBlock`, `ViT`,
`vit_s16` and `vit_b16`.

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
(`torch.utils.checkpoint`, non-reentrant), as `nn.remat` does. Dropout
and the V-MoE variant (`num_experts > 0`) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    Dense,
    DenseGeneral,
    LayerNorm,
    flax_cast,
    trunc_normal_fan_in_,
)
from deep_vision_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_min_tokens,
)


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


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=torch.float32)
        self.Attention_0 = Attention(dim, num_heads, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=torch.float32)
        self.Mlp_0 = Mlp(dim, dim * mlp_ratio, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # `LayerNorm(dtype=f32)(x).astype(x.dtype)` in the reference: the
        # f32 result rounded once to x's dtype, by the kernel itself
        x = x + self.Attention_0(self.LayerNorm_0(x, out_dtype=x.dtype))
        return x + self.Mlp_0(self.LayerNorm_1(x, out_dtype=x.dtype))


class ViT(nn.Module):
    """ViT classifier. Input NHWC (B, image_size, image_size, 3); output
    (B, num_classes) f32 logits."""

    def __init__(self, depth: int = 12, dim: int = 384, num_heads: int = 6,
                 patch: int = 16, num_classes: int = 1000,
                 mlp_ratio: int = 4, image_size: int = 224,
                 in_channels: int = 3, num_experts: int = 0,
                 dropout: float = 0.0, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_experts:
            raise NotImplementedError(
                "the V-MoE variant (num_experts > 0: MoeMlp, "
                "load_balancing_loss) is not ported yet")
        if dropout:
            raise NotImplementedError("ViT dropout is not ported yet")
        if image_size % patch:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch}")
        self.depth, self.dim, self.patch = depth, dim, patch
        self.image_size, self.remat, self.dtype = image_size, remat, dtype
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        for i in range(depth):
            setattr(self, f"ViTBlock_{i}",
                    ViTBlock(dim, num_heads, mlp_ratio, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(dim, dtype=torch.float32)
        self.Dense_0 = Dense(dim, num_classes, dtype=torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
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
        for i in range(self.depth):
            block = getattr(self, f"ViTBlock_{i}")
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x)
        x = self.LayerNorm_0(x.float()).mean(dim=1)  # token-mean pool
        return self.Dense_0(x)


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Draw every weight as flax initializes it, in module order from
    `generator`: the patch conv, the DenseGenerals and Denses
    lecun-normal over their fan-in with zero biases, `pos_embed` from
    normal(0.02), LayerNorms at scale 1 and bias 0."""
    for m in model.modules():
        if isinstance(m, DenseGeneral):
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
