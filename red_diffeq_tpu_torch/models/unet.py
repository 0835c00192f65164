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
from typing import Optional, Sequence, Union

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


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier-feature timestep embedding, (B,) -> (B, dim + 1): the
    timestep, then the sin and cos of 2 pi t w for ``dim // 2`` frequencies
    ``weights`` (standard normal at initialisation), learned, or held fixed
    with ``is_random`` (the JAX model's ``stop_gradient``)."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.is_random = is_random
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t):
        w = self.weights.detach() if self.is_random else self.weights
        t = t.float()[:, None]
        freqs = t * w[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


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
    """The denoiser: ``forward(x (B, channels, H, W), time (B,),
    x_self_cond=None)``; H and W must divide by 2**(stages-1).

    The JAX model's 16 fields in its order, with its defaults: ``init_dim``
    (the width of the 7x7 input convolution, default ``dim``),
    ``out_dim`` (default ``channels``, twice that with
    ``learned_variance``), ``dim_mults``, ``channels``,
    ``self_condition`` (the input is ``x_self_cond``, zeros if None,
    stacked before ``x`` on the channel axis), ``resnet_block_groups``
    (GroupNorm's groups), ``learned_variance``, ``learned_sinusoidal_cond``
    and ``random_fourier_features`` (the timestep embedded by
    :class:`RandomOrLearnedSinusoidalPosEmb` of ``learned_sinusoidal_dim``
    frequencies, as ``sinu_pos_emb``, fixed with random Fourier features),
    ``sinusoidal_pos_emb_theta``, ``attn_dim_head`` and ``attn_heads`` (one
    value or one per stage), ``full_attn`` (per stage: full softmax
    attention, else linear; default only the innermost stage) and
    ``flash_attn`` (accepted and changing nothing, as in the JAX model).
    The bottleneck takes the innermost stage's heads. With the defaults
    the parameter names are those of the shipped prior."""

    def __init__(self, dim: int, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 1,
                 self_condition: bool = False, resnet_block_groups: int = 8,
                 learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16,
                 sinusoidal_pos_emb_theta: float = 10000.0,
                 attn_dim_head: Union[int, Sequence[int]] = 32,
                 attn_heads: Union[int, Sequence[int]] = 4,
                 full_attn: Optional[Sequence[bool]] = None,
                 flash_attn: bool = False):
        super().__init__()
        self.dim = dim
        self.channels = channels
        self.self_condition = self_condition
        self.theta = sinusoidal_pos_emb_theta
        n = len(dim_mults)
        self.num_stages = n

        def per_stage(v):
            return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n

        full = (tuple(full_attn) if full_attn is not None
                else (False,) * (n - 1) + (True,))
        heads, dim_heads = per_stage(attn_heads), per_stage(attn_dim_head)
        init_dim = init_dim or dim
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        groups = resnet_block_groups

        def attn(stage, d):
            cls = Attention if full[stage] else LinearAttention
            return cls(d, heads=heads[stage], dim_head=dim_heads[stage])

        def block(d_in, d_out):
            return ResnetBlock(d_in, d_out, time_dim, groups)

        if learned_sinusoidal_cond or random_fourier_features:
            self.sinu_pos_emb = RandomOrLearnedSinusoidalPosEmb(
                learned_sinusoidal_dim, random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            self.sinu_pos_emb = None
            fourier_dim = dim
        self.time_dense_0 = nn.Linear(fourier_dim, time_dim)
        self.time_dense_1 = nn.Linear(time_dim, time_dim)
        self.init_conv = nn.Conv2d(channels * (2 if self_condition else 1),
                                   init_dim, 7, padding=3)

        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind == n - 1
            self.add_module(f'down_{ind}_block1', block(d_in, d_in))
            self.add_module(f'down_{ind}_block2', block(d_in, d_in))
            self.add_module(f'down_{ind}_attn', attn(ind, d_in))
            self.add_module(f'down_{ind}_downsample',
                            nn.Conv2d(d_in, d_out, 3, padding=1) if last
                            else nn.Conv2d(4 * d_in, d_out, 1))

        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = Attention(mid, heads=heads[-1], dim_head=dim_heads[-1])
        self.mid_block2 = block(mid, mid)

        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            self.add_module(f'up_{ind}_block1', block(d_out + d_in, d_out))
            self.add_module(f'up_{ind}_block2', block(d_out + d_in, d_out))
            self.add_module(f'up_{ind}_attn', attn(n - 1 - ind, d_out))
            self.add_module(f'up_{ind}_upsample',
                            nn.Conv2d(d_out, d_in, 3, padding=1))

        # Its input is the last stage's output and the init conv's (2 *
        # init_dim wide); the JAX block, declared 2 * dim wide, always has
        # its 1x1 projection.
        self.final_res_block = block(2 * init_dim, dim)
        if self.final_res_block.res_conv is None:
            self.final_res_block.res_conv = nn.Conv2d(dim, dim, 1)
        self.final_conv = nn.Conv2d(
            dim, out_dim or channels * (2 if learned_variance else 1), 1)

    @property
    def downsample_factor(self) -> int:
        """2**(stages - 1): the factor H and W must divide by, the JAX
        model's property."""
        return 2 ** (self.num_stages - 1)

    def forward(self, x, time, x_self_cond=None):
        factor = self.downsample_factor
        if x.shape[-2] % factor or x.shape[-1] % factor:
            raise ValueError(f'input spatial dims {tuple(x.shape[-2:])} must '
                             f'divide by {factor}')
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=1)
        with fp32_convolutions():
            return self._forward(x, time)

    def _forward(self, x, time):
        n = self.num_stages
        m = self.get_submodule
        emb = (self.sinu_pos_emb(time) if self.sinu_pos_emb is not None
               else sinusoidal_pos_emb(time, self.dim, self.theta))
        t = self.time_dense_1(F.gelu(self.time_dense_0(emb.to(x.dtype))))

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
