"""The yardstick's work counts and the chip's peaks.

Operations and bytes are functions of the problem's shapes alone, never of
how the program chunks, launches or keeps its fields:

* Solver operations: the plain scheme's fp32 operations per cell per time
  step of one pass, over every field (sample x shot) and step. Forward:
  the 4th-order Laplacian (6 additions, 2 products, 1 addition), then
  t1*p1 - t2*p0 + alpha*L (3 products, 2 additions): 14. Adjoint: the
  adjoint field's step (14, the same operator transposed), the forward
  field taken one step back (14: the reverse route runs the scheme
  backwards, the taped route replays it from its tape) and the three
  coefficient gradients (3 products, 3 additions): 34. The routes differ
  in what they store, which is no useful work, so both count alike.
* Solver bytes: each input of a pass read once and each output written
  once per pass. Forward: alpha, t1, t2 (per sample), the source row
  (per field), the wavelet; out, the seismogram and the last two
  wavefields. Adjoint: the same inputs, the last two wavefields and the
  seismogram's cotangent; out, the three coefficient gradients and the
  source row's.
  ``chip_smoke.py:bounds`` counts the bytes of each chunk call (the
  coefficients read and the carries written once a chunk), so its bound
  grows with the number of chunks and would move when a redesign changes
  the chunking; these counts do not.
* U-Net FLOPs: the reference U-Net's convolutions and products as
  ``torch.utils.flop_counter`` counts them on the meta device (no memory,
  no device), forward alone or forward and backward.
"""
import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FLOPS = {'fp32': 67e12, 'tf32': 495e12, 'bf16': 989e12}
PEAK_BYTES_PER_S = 3.35e12

FWD_OPS_PER_CELL, ADJ_OPS_PER_CELL = 14, 34


def solver_pass(batch, ns, hp, wp, nt, ng):
    """{'forward': (ops, bytes), 'adjoint': (ops, bytes)} of one pass of
    ``batch`` samples of ``ns`` shots on the padded ``hp`` x ``wp`` grid,
    ``nt`` steps, ``ng`` receivers (fp32)."""
    fields, cells = batch * ns, hp * wp
    coeffs = 3 * batch * cells
    common = coeffs + fields * wp + nt
    last = 2 * fields * cells
    seis = fields * nt * ng
    return {
        'forward': (FWD_OPS_PER_CELL * fields * cells * nt,
                    4 * (common + seis + last)),
        'adjoint': (ADJ_OPS_PER_CELL * fields * cells * nt,
                    4 * (common + last + seis + coeffs + fields)),
    }


def least_seconds(ops, nbytes, peak=PEAK_FLOPS['fp32']):
    """The least time the chip needs: the larger of operations over the
    peak rate and bytes over the memory bandwidth."""
    return max(ops / peak, nbytes / PEAK_BYTES_PER_S)


def unet_flops(dim, dim_mults, image, batch, backward=False) -> int:
    """FLOPs of the reference U-Net on a (batch, 1, image, image) input:
    the forward, or with ``backward`` the forward and the parameters'
    backward (the input takes no gradient)."""
    from h100_bench.reference.unet import Unet
    with torch.device('meta'):
        net = Unet(dim=dim, dim_mults=tuple(dim_mults))
        x = torch.zeros(batch, 1, image, image)
        t = torch.zeros(batch, dtype=torch.long)
    counter = FlopCounterMode(display=False)
    with counter:
        out = net(x, t)
        if backward:
            out.sum().backward()
    return int(counter.get_total_flops())
