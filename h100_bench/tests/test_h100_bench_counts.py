"""The yardstick's counts: the solver's operations and bytes equal a hand
count, the rooflines read the same however the work is split into
launches, and the U-Net's FLOPs equal a count of its products."""
import pytest
import torch

from h100_bench.lib import counts, harness, tracing


def test_solver_hand_count():
    # 2 samples of 3 shots, 10x12 padded grid, 5 steps, 4 receivers.
    c = counts.solver_pass(2, 3, 10, 12, 5, 4)
    cells, fields = 120, 6
    assert c['forward'][0] == 14 * fields * cells * 5
    assert c['adjoint'][0] == 34 * fields * cells * 5
    coeffs = 3 * 2 * cells                     # alpha, t1, t2
    inputs = coeffs + fields * 12 + 5          # + source rows + wavelet
    last = 2 * fields * cells                  # the last two wavefields
    seis = fields * 5 * 4
    assert c['forward'][1] == 4 * (inputs + seis + last)
    assert c['adjoint'][1] == 4 * (inputs + last + seis + coeffs + fields)
    assert counts.least_seconds(67e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0


class FakeTrace:
    def __init__(self, kernels, window_s=1.0, busy_s=0.5):
        self.kernels, self.window_s, self.busy_s = kernels, window_s, busy_s

    def kernel_time(self, match=None):
        return sum(d for n, d in self.kernels if match is None or match(n))


@pytest.mark.parametrize('launches', [(250, 250, 50), (1000, 50, 5)])
def test_rooflines_ignore_how_work_is_launched(launches):
    """The same device time in 250 or 1000 launches of the forward (any
    chunking) reads the same share."""
    nf, nb, ns = launches
    trace = FakeTrace(
        [('void (anonymous namespace)::fwd_step<4>(...)', 15600.0 / nf)] * nf
        + [('bwd_reverse_step<4>', 44800.0 / nb)] * nb
        + [('sum_shots<5>', 540.0 / ns)] * ns
        + [('cudnn::conv', 7000.0), ('bwd_tape_step_like_name', 1.0)])
    ctx = dict(trace=trace, steps=1,
               solver=counts.solver_pass(4, 5, 310, 310, 1000, 70),
               solver_keys=['fwd_step', 'bwd_reverse_step', 'sum_shots',
                            'tape_step', 'bwd_tape_step'],
               forward_keys=['fwd_step'])
    fwd = harness.reader('fwd_roofline_pct')(ctx)
    adj = harness.reader('adjoint_roofline_pct')(ctx)
    least = counts.least_seconds(*ctx['solver']['forward'])
    assert fwd == pytest.approx(100 * least / 15.6e-3)
    least = counts.least_seconds(*ctx['solver']['adjoint'])
    assert adj == pytest.approx(100 * least / 45.34e-3)
    assert harness.reader('nonsolver_ms_per_step')(ctx) == pytest.approx(
        7.001)


def test_readers_absent_without_a_trace():
    for name in ('fwd_roofline_pct', 'adjoint_roofline_pct',
                 'nonsolver_ms_per_step', 'idle_pct.inv', 'idle_pct.train',
                 'mfu.inv', 'mfu.train'):
        assert harness.reader(name)({'trace': None, 'steps': 10}) is None


def test_kernel_names_match_whole_words():
    is_tape = tracing.kernels_of(['tape_step'])
    assert is_tape('tape_step<16>')
    assert not is_tape('bwd_tape_step<4>')
    assert not is_tape('tape_step_stream<2>')


def test_unet_flops_equal_a_count_of_products():
    from h100_bench.reference.unet import Unet
    net = Unet(dim=8)
    total = []

    def conv(mod, args, out):
        w = mod.weight
        total.append(2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])

    def lin(mod, args, out):
        total.append(2 * out.numel() * mod.weight.shape[1])

    for m in net.modules():
        name = type(m).__name__
        if name == 'Conv':
            m.register_forward_hook(conv)
        elif name == 'Lin':
            m.register_forward_hook(lin)
    orig = net.ar.einsum

    def einsum(eq, a, b):
        ins = eq.split('->')[0].split(',')
        size = {}
        for letters, op in zip(ins, (a, b)):
            size.update(zip(letters, op.shape))
        n = 2
        for v in size.values():
            n *= v
        total.append(n)
        return orig(eq, a, b)

    net.ar.einsum = einsum
    net(torch.zeros(2, 1, 16, 16), torch.zeros(2, dtype=torch.long))
    flops = counts.unet_flops(8, (1, 2, 4, 8), 16, 2)
    assert flops == sum(total)
    assert counts.unet_flops(8, (1, 2, 4, 8), 16, 4) == 2 * flops
    both = counts.unet_flops(8, (1, 2, 4, 8), 16, 2, backward=True)
    assert 2 * flops < both <= 3 * flops
