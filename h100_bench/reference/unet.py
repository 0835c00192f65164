"""Plain reference of the denoising U-Net (the RED-DiffEq prior).

A frozen copy of the architecture the measured program serves and trains:
lucidrains' ``denoising-diffusion-pytorch`` U-Net as the JAX model defines
it (``dim`` 64, ``dim_mults`` (1, 2, 4, 8), GroupNorm of 8 groups with eps
1e-6, FiLM time conditioning, linear attention with 4 memory slots in the
outer stages and full attention in the innermost and the bottleneck,
RMSNorm clamped at 1e-12, ``space_to_depth`` packing channels as (p1, p2,
c), nearest upsampling). Parameter names are the program's, so one state
dict made by the benchmark loads into both. Every convolution, linear layer
and attention product goes through the tree's shared
:class:`~h100_bench.reference.arith.Arith`.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.arith import Arith


class Conv(nn.Module):
    def __init__(self, ar, c_in, c_out, k, padding=0, bias=True):
        super().__init__()
        self.ar, self.padding = ar, padding
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x):
        return self.ar.conv2d(x, self.weight, self.bias, padding=self.padding)


class Lin(nn.Module):
    def __init__(self, ar, c_in, c_out):
        super().__init__()
        self.ar = ar
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return self.ar.linear(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12) * self.g * math.sqrt(self.dim)


class Block(nn.Module):
    def __init__(self, ar, c_in, c_out):
        super().__init__()
        self.proj = Conv(ar, c_in, c_out, 3, padding=1)
        self.norm = nn.GroupNorm(8, c_out, eps=1e-6)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            x = x * (scale_shift[0] + 1.0) + scale_shift[1]
        return F.silu(x)


class ResnetBlock(nn.Module):
    def __init__(self, ar, c_in, c_out, time_dim):
        super().__init__()
        self.time_mlp = Lin(ar, time_dim, c_out * 2)
        self.block1 = Block(ar, c_in, c_out)
        self.block2 = Block(ar, c_out, c_out)
        self.res_conv = Conv(ar, c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, t):
        h_t = self.time_mlp(F.silu(t))[:, :, None, None]
        h = self.block2(self.block1(x, h_t.chunk(2, dim=1)))
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class LinearAttention(nn.Module):
    def __init__(self, ar, dim, heads=4, dim_head=32):
        super().__init__()
        self.ar, self.heads, self.dim_head = ar, heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv(ar, dim, heads * dim_head * 3, 1, bias=False)
        self.mem_kv = nn.Parameter(torch.zeros(2, heads, dim_head, 4))
        self.to_out = Conv(ar, heads * dim_head, dim, 1)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = self.to_qkv(self.norm(x)).reshape(b, 3, self.heads,
                                                self.dim_head, h * w)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        mk, mv = (m.expand(b, *m.shape) for m in self.mem_kv)
        k = torch.cat([mk, k], dim=-1).softmax(dim=-1)
        v = torch.cat([mv, v], dim=-1)
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        context = self.ar.einsum('bhdn,bhen->bhde', k, v)
        out = self.ar.einsum('bhde,bhdn->bhen', context, q)
        return self.out_norm(self.to_out(out.reshape(b, -1, h, w))) + x


class Attention(nn.Module):
    def __init__(self, ar, dim, heads=4, dim_head=32):
        super().__init__()
        self.ar, self.heads, self.dim_head = ar, heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv(ar, dim, heads * dim_head * 3, 1, bias=False)
        self.mem_kv = nn.Parameter(torch.zeros(2, heads, 4, dim_head))
        self.to_out = Conv(ar, heads * dim_head, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = self.to_qkv(self.norm(x)).reshape(
            b, 3, self.heads, self.dim_head, h * w).transpose(-1, -2)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        mk, mv = (m.expand(b, *m.shape) for m in self.mem_kv)
        k = torch.cat([mk, k], dim=-2)
        v = torch.cat([mv, v], dim=-2)
        attn = self.ar.einsum('bhid,bhjd->bhij', q, k) * (self.dim_head ** -0.5)
        out = self.ar.einsum('bhij,bhjd->bhid', attn.softmax(dim=-1), v)
        return self.to_out(out.transpose(-1, -2).reshape(b, -1, h, w)) + x


def space_to_depth(x):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def sinusoidal(t, dim, theta=10000.0):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(theta) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Unet(nn.Module):
    """``forward(x (B, 1, H, W), t (B,))``; H and W divide by 8."""

    def __init__(self, dim=64, dim_mults=(1, 2, 4, 8), channels=1,
                 ar=None):
        super().__init__()
        ar = ar or Arith()
        self.ar, self.dim, n = ar, dim, len(dim_mults)
        self.num_stages = n
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        td = dim * 4
        self.time_dense_0 = Lin(ar, dim, td)
        self.time_dense_1 = Lin(ar, td, td)
        self.init_conv = Conv(ar, channels, dim, 7, padding=3)
        for i, (a, b) in enumerate(in_out):
            last = i == n - 1
            self.add_module(f'down_{i}_block1', ResnetBlock(ar, a, a, td))
            self.add_module(f'down_{i}_block2', ResnetBlock(ar, a, a, td))
            self.add_module(f'down_{i}_attn', (Attention if last else
                                               LinearAttention)(ar, a))
            self.add_module(f'down_{i}_downsample',
                            Conv(ar, a, b, 3, padding=1) if last
                            else Conv(ar, 4 * a, b, 1))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(ar, mid, mid, td)
        self.mid_attn = Attention(ar, mid)
        self.mid_block2 = ResnetBlock(ar, mid, mid, td)
        for i, (a, b) in enumerate(reversed(in_out)):
            self.add_module(f'up_{i}_block1', ResnetBlock(ar, b + a, b, td))
            self.add_module(f'up_{i}_block2', ResnetBlock(ar, b + a, b, td))
            self.add_module(f'up_{i}_attn', (Attention if i == 0 else
                                             LinearAttention)(ar, b))
            self.add_module(f'up_{i}_upsample', Conv(ar, b, a, 3, padding=1))
        self.final_res_block = ResnetBlock(ar, 2 * dim, dim, td)
        self.final_conv = Conv(ar, dim, channels, 1)

    def forward(self, x, time):
        m, n = self.get_submodule, self.num_stages
        t = self.time_dense_1(F.gelu(self.time_dense_0(
            sinusoidal(time, self.dim))))
        x = self.init_conv(x)
        r, skips = x, []
        for i in range(n):
            x = m(f'down_{i}_block1')(x, t)
            skips.append(x)
            x = m(f'down_{i}_attn')(m(f'down_{i}_block2')(x, t))
            skips.append(x)
            down = m(f'down_{i}_downsample')
            x = down(x) if i == n - 1 else down(space_to_depth(x))
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for i in range(n):
            x = m(f'up_{i}_block1')(torch.cat([x, skips.pop()], dim=1), t)
            x = m(f'up_{i}_block2')(torch.cat([x, skips.pop()], dim=1), t)
            x = m(f'up_{i}_attn')(x)
            up = m(f'up_{i}_upsample')
            x = up(x) if i == n - 1 else up(
                x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1))
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x)
