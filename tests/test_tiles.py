"""HEVC tiles: host path round-trip, shard_map equality, HM conformance."""

import os
import subprocess

import numpy as np
import pytest

from test_intra_codec import HM_DECODER, synth_frame
from video_codecs_tpu.models.hevc import headers, intra_codec
from video_codecs_tpu.parallel import tiles
from video_codecs_tpu.utils import yuv


def _cfg(tile_columns, width=512):
    # HM enforces tile columns >= 256 luma samples wide (TComPicSym:274)
    return headers.HevcConfig(width=width, height=128, qp=30,
                              tile_columns=tile_columns)


def test_tiled_host_roundtrip():
    cfg = _cfg(2)
    enc = intra_codec.IntraEncoder(cfg)
    frames = [synth_frame(512, 128, s) for s in range(2)]
    stream, recons = enc.encode_sequence(frames)
    dec = intra_codec.IntraDecoder()
    out = dec.decode(stream)
    assert dec.hash_status == [True, True]
    for (ry, ru, rv), (dy, du, dv) in zip(recons, out):
        np.testing.assert_array_equal(ry, dy)
        np.testing.assert_array_equal(ru, du)
        np.testing.assert_array_equal(rv, dv)


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_shard_map_tiles_match_host(n_tiles):
    """Device tile-parallel encode == sequential host encode, byte for byte."""
    import jax
    assert len(jax.devices()) >= n_tiles
    cfg = _cfg(n_tiles, width=256 * n_tiles)
    frames = [synth_frame(256 * n_tiles, 128, s) for s in range(2)]
    enc = intra_codec.IntraEncoder(cfg)
    stream_host, rec_host = enc.encode_sequence(frames)
    stream_dev, rec_dev = tiles.encode_sequence_tiles(cfg, frames)
    for (a, b) in zip(rec_host, rec_dev):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert stream_host == stream_dev


def test_tiles_on_one_device_match_host():
    """A one-device mesh runs every tile in turn: same bytes as the host."""
    import jax
    from jax.sharding import Mesh

    cfg = _cfg(2)
    frames = [synth_frame(512, 128, s) for s in range(2)]
    stream_host, _ = intra_codec.IntraEncoder(cfg).encode_sequence(frames)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tile",))
    stream_dev, _ = tiles.encode_sequence_tiles(cfg, frames, mesh)
    assert stream_host == stream_dev


@pytest.mark.skipif(not os.path.exists(HM_DECODER),
                    reason="HM reference decoder not built")
def test_tiles_hm_conformance(tmp_path):
    cfg = _cfg(2)
    frames = [synth_frame(512, 128, s) for s in range(2)]
    stream, recons = tiles.encode_sequence_tiles(cfg, frames)
    p = tmp_path / "tiles.bin"
    rec = tmp_path / "tiles_rec.yuv"
    p.write_bytes(stream)
    r = subprocess.run([HM_DECODER, "-b", str(p), "-o", str(rec)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("(OK)") == 2 and "ERROR" not in r.stdout, r.stdout
    ry, ru, rv = yuv.read_frames(str(rec), 512, 128)
    for i, (ey, eu, ev) in enumerate(recons):
        np.testing.assert_array_equal(ry[i], ey.astype(np.uint8))


def test_wpp_roundtrip():
    cfg = headers.HevcConfig(width=64, height=48, qp=30, wpp=True)
    enc = intra_codec.IntraEncoder(cfg)
    frames = [synth_frame(64, 48, s) for s in range(2)]
    stream, recons = enc.encode_sequence(frames)
    dec = intra_codec.IntraDecoder()
    out = dec.decode(stream)
    assert dec.hash_status == [True, True]
    np.testing.assert_array_equal(out[0][0], recons[0][0])


@pytest.mark.skipif(not os.path.exists(HM_DECODER),
                    reason="HM reference decoder not built")
def test_wpp_hm_conformance(tmp_path):
    cfg = headers.HevcConfig(width=64, height=48, qp=30, wpp=True)
    enc = intra_codec.IntraEncoder(cfg)
    frames = [synth_frame(64, 48, s) for s in range(2)]
    stream, recons = enc.encode_sequence(frames)
    p = tmp_path / "wpp.bin"
    rec = tmp_path / "wpp.yuv"
    p.write_bytes(stream)
    r = subprocess.run([HM_DECODER, "-b", str(p), "-o", str(rec)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("(OK)") == 2 and "ERROR" not in r.stdout, r.stdout
    ry, _, _ = yuv.read_frames(str(rec), 64, 48)
    np.testing.assert_array_equal(ry[0], recons[0][0].astype(np.uint8))
