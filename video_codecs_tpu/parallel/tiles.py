"""Tile-parallel encoding over a device mesh (HEVC tiles as real TP).

SURVEY.md §2.9: the reference's tiles (TComPicSym tile maps) are the
bitstream construct every HEVC implementation shards on; here they become
actual tensor parallelism.  Each device receives one tile column's pixels
via shard_map and runs the FULL per-tile pipeline (batched 35-mode sweep +
wavefront recon) with zero cross-device communication — tile independence
is exactly what the standard guarantees.  A mesh of one device runs the
same per-tile pipeline tile after tile.  Cross-tile deblocking
(loop_filter_across_tiles=1) runs after an all-gather of the recon planes,
and the per-tile CABAC substreams serialize concurrently on host, joined
by slice-header entry points.

Produces byte-identical streams to the sequential host path
(tests/test_tiles.py) and decodes in HM's reference decoder.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu.entropy import bitstream as bs
from video_codecs_tpu.entropy import cabac, ctx
from video_codecs_tpu.models.hevc import encoder_jax, headers
from video_codecs_tpu.models.hevc import intra_codec as ic
from video_codecs_tpu.ops import deblock as deblock_ops


def encode_frame_tiles(cfg: headers.HevcConfig, y, u, v, mesh=None):
    """Encode one all-intra frame with cfg.tile_columns tiles sharded over
    a device mesh (one tile per device, or every tile on a mesh of one
    device); returns ([slice_nal, sei_nal], recon)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    n_tiles = cfg.tile_columns
    bw, bh = cfg.width // 16, cfg.height // 16
    bounds = cfg.tile_col_bounds()
    widths = {tx1 - tx0 for (tx0, tx1) in bounds}
    assert len(widths) == 1, "shard_map path needs uniform tile widths"
    tbw = widths.pop()

    if mesh is None:
        devs = np.array(jax.devices()[:n_tiles])
        assert devs.size == n_tiles, "not enough devices for tile count"
        mesh = Mesh(devs, ("tile",))

    qp, qp_c = cfg.qp, ic.chroma_qp(cfg.qp)

    def per_tile(yt, ut, vt):
        yi = yt.astype(jnp.int32)
        modes = encoder_jax.decide_modes_device(yi, qp, tbw, bh)
        st = encoder_jax.encode_frame_device(
            yi, ut.astype(jnp.int32), vt.astype(jnp.int32), modes, qp,
            qp_c, tbw, bh)
        return (st["rec_y"], st["rec_u"], st["rec_v"], modes,
                st["levels_y"], st["levels_cb"], st["levels_cr"], st["cbf"])

    # 1: concatenated along columns (picture layout); 0: along blocks
    axes = (1, 1, 1, 1, 0, 0, 0, 1)
    if mesh.devices.size == 1:
        tile_fn = jax.jit(per_tile)
        tw, cw = tbw * 16, tbw * 8
        parts = [tile_fn(jnp.asarray(y[:, t * tw:(t + 1) * tw]),
                         jnp.asarray(u[:, t * cw:(t + 1) * cw]),
                         jnp.asarray(v[:, t * cw:(t + 1) * cw]))
                 for t in range(n_tiles)]
        out = tuple(jnp.concatenate([p[i] for p in parts], axis=a)
                    for i, a in enumerate(axes))
    else:
        sharded = jax.shard_map(
            per_tile, mesh=mesh,
            in_specs=(P(None, "tile"), P(None, "tile"), P(None, "tile")),
            out_specs=tuple(P(None, "tile") if a else P("tile")
                            for a in axes),
            check_vma=False)
        out = jax.jit(sharded)(jnp.asarray(y), jnp.asarray(u),
                               jnp.asarray(v))
    rec_y, rec_u, rec_v, modes_t, lv_y, lv_cb, lv_cr, cbf = jax.device_get(out)

    # cross-tile deblocking on the assembled picture (filter crosses tiles)
    if not cfg.deblocking_disabled:
        rec_y, rec_u, rec_v = deblock_ops.deblock_420_np(
            np.asarray(rec_y), np.asarray(rec_u), np.asarray(rec_v), qp)

    # reassemble per-tile block arrays into picture raster indexing
    # (cbf is recomputed from the levels, avoiding per-shard layout games)
    _ = cbf
    ctus: list[ic.CtuData] = [None] * (bw * bh)  # type: ignore
    for t, (tx0, tx1) in enumerate(bounds):
        for by in range(bh):
            for lx in range(tbw):
                i_local = t * (tbw * bh) + by * tbw + lx
                bx = tx0 + lx
                lvy = np.asarray(lv_y[i_local])
                lvb = np.asarray(lv_cb[i_local])
                lvr = np.asarray(lv_cr[i_local])
                ctus[by * bw + bx] = ic.CtuData(
                    mode=int(modes_t[by, bx]),
                    levels_y=lvy if lvy.any() else None,
                    levels_cb=lvb if lvb.any() else None,
                    levels_cr=lvr if lvr.any() else None)

    enc = ic.IntraEncoder(cfg)
    slice_nal = enc._encode_slice(ctus)
    sei_nal = enc._hash_sei(np.asarray(rec_y), np.asarray(rec_u),
                            np.asarray(rec_v))
    return [slice_nal, sei_nal], (np.asarray(rec_y), np.asarray(rec_u),
                                  np.asarray(rec_v))


def encode_sequence_tiles(cfg: headers.HevcConfig, frames, mesh=None):
    enc = ic.IntraEncoder(cfg)
    nals = enc.stream_headers()
    recons = []
    for (y, u, v) in frames:
        frame_nals, rec = encode_frame_tiles(cfg, y, u, v, mesh)
        nals.extend(frame_nals)
        recons.append(rec)
    return bs.annexb(nals), recons
