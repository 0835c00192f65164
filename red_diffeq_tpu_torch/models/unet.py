"""Denoising U-Net as NCHW PyTorch modules.

Counterpart of ``red_diffeq_tpu/models/unet.py``. Modules carry the flax
module names, so a flax parameter path maps onto a ``state_dict`` key by
joining it with dots (``io/checkpoints.py`` does that). Numerics follow the
JAX model: GroupNorm with flax's ``eps=1e-6``, exact GELU, RMSNorm clamped
at 1e-12, attention as plain einsum and softmax, and ``space_to_depth``
packing the channel axis as (p1, p2, c). Convolutions run in full fp32
(no TF32) on the card.
"""
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from red_diffeq_tpu_torch.utils.precision import fp32_convolutions


class RMSNorm(nn.Module):
    """Channel-wise RMS norm with a learned gain ``g`` (1, C, 1, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12) * self.g * math.sqrt(self.dim)


def sinusoidal_pos_emb(t, dim: int, theta: float = 10000.0):
    """Transformer sin/cos embedding of the timestep, fp32: (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(theta) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> (scale+1)*x+shift -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-6)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two conv blocks with FiLM time conditioning and a 1x1 residual
    projection when the width changes."""

    def __init__(self, dim: int, dim_out: int, time_dim: int,
                 groups: int = 8):
        super().__init__()
        self.time_mlp = nn.Linear(time_dim, dim_out * 2)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else None)

    def forward(self, x, time_emb):
        h_t = self.time_mlp(F.silu(time_emb))[:, :, None, None]
        h = self.block1(x, h_t.chunk(2, dim=1))
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


def _qkv(attn, x):
    """(B, 3, heads, dim_head, N) from the 1x1 projection; N runs over
    (y, x) as the NHWC flatten of the JAX model does."""
    b, _, h, w = x.shape
    qkv = attn.to_qkv(attn.norm(x))
    return qkv.reshape(b, 3, attn.heads, attn.dim_head, h * w)


class LinearAttention(nn.Module):
    """Linear (kernelised) attention with memory kv slots; ``mem_kv`` is
    (2, heads, dim_head, num_mem_kv)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 num_mem_kv: int = 4):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, dim_head, num_mem_kv))
        self.to_out = nn.Conv2d(hidden, dim, 1)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = _qkv(self, x)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]        # (B, h, d, N)
        mk, mv = (m.expand(b, *m.shape) for m in self.mem_kv)
        k = torch.cat([mk, k], dim=-1)
        v = torch.cat([mv, v], dim=-1)
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        k = k.softmax(dim=-1)
        context = torch.einsum('bhdn,bhen->bhde', k, v)
        out = torch.einsum('bhde,bhdn->bhen', context, q)  # (B, h, e, N)
        out = self.to_out(out.reshape(b, -1, h, w))
        return self.out_norm(out) + x


class Attention(nn.Module):
    """Full softmax attention over all positions plus memory kv;
    ``mem_kv`` is (2, heads, num_mem_kv, dim_head)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 num_mem_kv: int = 4):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv, dim_head))
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = _qkv(self, x).transpose(-1, -2)            # (B, 3, h, N, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        mk, mv = (m.expand(b, *m.shape) for m in self.mem_kv)
        k = torch.cat([mk, k], dim=-2)
        v = torch.cat([mv, v], dim=-2)
        attn = torch.einsum('bhid,bhjd->bhij', q, k) * (self.dim_head ** -0.5)
        attn = attn.softmax(dim=-1)
        out = torch.einsum('bhij,bhjd->bhid', attn, v)   # (B, h, N, d)
        out = out.transpose(-1, -2).reshape(b, -1, h, w)
        return self.to_out(out) + x


def space_to_depth(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channels packed as (p1, p2, c)
    like the JAX model's NHWC ``space_to_depth`` (not einops' (c, p1, p2))."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def nearest_upsample(x):
    """2x nearest-neighbour upsample."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Unet(nn.Module):
    """The denoiser: ``forward(x (B, channels, H, W), time (B,))``; H and W
    must divide by 2**(stages-1). The JAX model's defaults: GroupNorm(8),
    4 attention heads of width 32, linear attention in every stage but the
    innermost, which has full attention."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 1):
        super().__init__()
        self.dim = dim
        self.channels = channels
        n = len(dim_mults)
        self.num_stages = n
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4

        def attn(ind, d):
            return Attention(d) if ind == n - 1 else LinearAttention(d)

        self.time_dense_0 = nn.Linear(dim, time_dim)
        self.time_dense_1 = nn.Linear(time_dim, time_dim)
        self.init_conv = nn.Conv2d(channels, dim, 7, padding=3)

        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind == n - 1
            self.add_module(f'down_{ind}_block1',
                            ResnetBlock(d_in, d_in, time_dim))
            self.add_module(f'down_{ind}_block2',
                            ResnetBlock(d_in, d_in, time_dim))
            self.add_module(f'down_{ind}_attn', attn(ind, d_in))
            self.add_module(f'down_{ind}_downsample',
                            nn.Conv2d(d_in, d_out, 3, padding=1) if last
                            else nn.Conv2d(4 * d_in, d_out, 1))

        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim)
        self.mid_attn = Attention(mid)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim)

        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            self.add_module(f'up_{ind}_block1', ResnetBlock(
                d_out + d_in, d_out, time_dim))
            self.add_module(f'up_{ind}_block2', ResnetBlock(
                d_out + d_in, d_out, time_dim))
            self.add_module(f'up_{ind}_attn', attn(n - 1 - ind, d_out))
            self.add_module(f'up_{ind}_upsample',
                            nn.Conv2d(d_out, d_in, 3, padding=1))

        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim)
        self.final_conv = nn.Conv2d(dim, channels, 1)

    def forward(self, x, time):
        factor = 2 ** (self.num_stages - 1)
        if x.shape[-2] % factor or x.shape[-1] % factor:
            raise ValueError(f'input spatial dims {tuple(x.shape[-2:])} must '
                             f'divide by {factor}')
        with fp32_convolutions():
            return self._forward(x, time)

    def _forward(self, x, time):
        n = self.num_stages
        m = self.get_submodule
        emb = sinusoidal_pos_emb(time, self.dim).to(x.dtype)
        t = self.time_dense_1(F.gelu(self.time_dense_0(emb)))

        x = self.init_conv(x)
        r = x
        skips = []
        for ind in range(n):
            x = m(f'down_{ind}_block1')(x, t)
            skips.append(x)
            x = m(f'down_{ind}_block2')(x, t)
            x = m(f'down_{ind}_attn')(x)
            skips.append(x)
            down = m(f'down_{ind}_downsample')
            x = down(x) if ind == n - 1 else down(space_to_depth(x))

        x = self.mid_block1(x, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t)

        for ind in range(n):
            x = torch.cat([x, skips.pop()], dim=1)
            x = m(f'up_{ind}_block1')(x, t)
            x = torch.cat([x, skips.pop()], dim=1)
            x = m(f'up_{ind}_block2')(x, t)
            x = m(f'up_{ind}_attn')(x)
            up = m(f'up_{ind}_upsample')
            x = up(x) if ind == n - 1 else up(nearest_upsample(x))

        x = torch.cat([x, r], dim=1)
        x = self.final_res_block(x, t)
        return self.final_conv(x)
