"""chip_smoke.py on the CPU: its device gate refuses this backend, and each
phase-1 parity check passes at a tiny picture size.  The phases themselves
run on a card in the `gpu`-marked test."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from video_codecs_tpu.ops import intra  # noqa: E402

TINY = (32, 64)          # (h, w): a few blocks of every size


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.device_gate()
    assert "no GPU" in str(e.value.code)


@pytest.mark.parametrize("op", sorted(chip_smoke.OPS))
def test_op_parity_tiny(op):
    rows = chip_smoke.OPS[op](np.random.default_rng(1), TINY)
    assert rows
    for r in rows:
        assert chip_smoke.row_ok(r), r


def tf32(x) -> np.ndarray:
    """Round float32 values to TF32 (10 explicit mantissa bits), nearest
    even, as a tensor core reads its inputs."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> 13) & 1)) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_intra_einsum_exact_under_tf32(bit_depth):
    """predict_intra's f32 einsum stays exact if the card runs it in TF32:
    every weight and (smoothed) sample fits 11 significant bits, and every
    sum stays below 2**24."""
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        ref = chip_smoke.intra_refs(np.random.default_rng(log2), 8, n,
                                    bit_depth).astype(np.int64)
        mid = (ref[:, :-2] + 2 * ref[:, 1:-1] + ref[:, 2:] + 2) >> 2
        ref2 = np.concatenate([ref, ref[:, :1], mid, ref[:, -1:]], axis=1)
        for luma in (True, False):
            w, _, _ = intra._mode_weights(log2, luma)
            exact = np.einsum("br,mpr->bmp", ref2, w.astype(np.int64))
            assert np.abs(exact).max() < 2 ** 24
            np.testing.assert_array_equal(tf32(w), w)
            np.testing.assert_array_equal(tf32(ref2), ref2)
            got = np.einsum("br,mpr->bmp", tf32(ref2), tf32(w),
                            dtype=np.float32)
            np.testing.assert_array_equal(got.astype(np.int64), exact)


def test_tf32_rounding_drops_low_bits():
    """The emulation above does round: 2**11 + 1 is not a TF32 value."""
    assert tf32(np.float32(2049.0)) == 2048.0
    assert tf32(np.float32(2047.0)) == 2047.0


@pytest.fixture
def card():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {devs[0].platform}")
    return devs


@pytest.mark.gpu
def test_smoke_phases_on_card(card):
    assert chip_smoke.main([]) == 0
