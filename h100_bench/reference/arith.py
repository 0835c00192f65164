"""The arithmetic of the reference: plain fp32, or TF32 for the control.

The reference states fp32 with TF32 off, as the measured program runs its
solver, U-Net and SSIM. The control of the output check is the same
reference one precision lower: TF32, whose tensor-core products take
operands rounded to a 10-bit mantissa and add in fp32. ``Arith(tf32=True)``
rounds both operands of every product (the stencil's, each convolution's,
linear layer's and attention product's) that way before an fp32 product,
on any device, so the control runs alike on the card and in the CPU tests.
The rounding passes gradients straight through, so a TF32 step's gradient
is the fp32 backward of its rounded forward.
"""
import contextlib

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest TF32 value, ties to even."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0xFFF + lsb, ~0x1FFF)
    return bits.view(torch.float32)


@contextlib.contextmanager
def fp32_math():
    """cuDNN's and cuBLAS's TF32 off for the block, then restored."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Arith:
    """Products in fp32 (``tf32=False``) or with TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def r(self, x):
        """``x`` (a tensor or a number) as a TF32 operand, or as it is."""
        if not self.tf32:
            return x
        if not torch.is_tensor(x):
            return float(round_tf32(torch.tensor(float(x))))
        if not x.is_floating_point():
            return x
        return x + (round_tf32(x) - x).detach()

    def mul(self, a, b):
        return self.r(a) * self.r(b)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.r(x), self.r(w), b, **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))
