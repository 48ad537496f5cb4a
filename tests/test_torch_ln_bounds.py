"""``chip_smoke.py:ln_close``'s bounds on the LayerNorm kernels' f32 row
mean and dx, on the CPU: each must accept every correctly rounded result
and still reject a wrong one.

The card check holds each forward's row mean to its plain version within
1e-5 x |plain| + 2 C 2^-24 mean|row|. That accepts any order of the same
f32 sum, also on rows whose mean cancels to near 0 (where the relative term
alone rejects a correctly rounded mean), and still rejects a mean that
leaves one element out. A backward's dx on a constant row is held to the
float64 dx, not to the plain version.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from bifold_tpu_torch.ops import layer_norm as ln  # noqa: E402


@pytest.mark.parametrize("c", [128, 512, 1024])
def test_mean_bound_takes_any_summation_order(c):
    gen = torch.Generator().manual_seed(c)
    rows = torch.randn(4746, c, generator=gen) + torch.randn(4746, c, generator=gen)
    _, plain, _ = ln.ln_forward_plain(rows, torch.ones(c), torch.zeros(c), 1e-5)
    rounded_once = rows.double().mean(-1, keepdim=True).float()
    reversed_order = rows.flip(-1).cumsum(-1)[:, -1:] / c
    one_left_out = rows[:, 1:].sum(-1, keepdim=True) / c

    def held(mean):
        return chip_smoke.ln_close(mean, plain, "mean", torch.float32, rows=rows)[2]

    assert not bool(((rounded_once - plain).abs() <= 1e-5 * plain.abs()).all())
    assert held(rounded_once) and held(reversed_order)
    assert not held(one_left_out)


def test_f32_dx_on_constant_rows_is_held_to_float64():
    """On a constant row rstd = 1/sqrt(eps) = 1000 magnifies the plain
    version's own rounding of its row means, so an f32 dx there is held to
    the float64 dx (no further from it than the plain version, plus 1e-5
    and the kernel's rounding bound), and elsewhere to the plain version
    within 1e-5 x max(1, |plain|)."""
    gen = torch.Generator().manual_seed(0)
    c = 256
    x = torch.randn(5, c, generator=gen) * 2 + 0.5
    x[2] = 1.0
    dy = torch.randn(5, c, generator=gen)
    scale = torch.randn(c, generator=gen) * 0.1 + 1.0
    _, mean, rstd = ln.ln_forward_plain(x, scale, torch.zeros(c), 1e-6)
    plain = ln.ln_backward_plain(x, dy, mean, rstd, scale)[0]
    exact = chip_smoke.ln_exact(x, dy, None, mean, rstd, scale)

    def held(dx):
        return chip_smoke.ln_close(dx, plain, "dx", torch.float32, exact)[2]

    nearest = exact["dx"].float()
    assert float((nearest - plain)[2].abs().max()) > 1e-5      # apart on the constant row
    assert held(nearest)
    off_constant = plain.clone()
    off_constant[2] += 1e-3
    off_random = plain.clone()
    off_random[0, 7] += 3e-5
    assert not held(off_constant) and not held(off_random)
