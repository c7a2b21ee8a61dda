"""Leaf histograms, the plain version.

The port's counterpart of `lightgbm_tpu/ops/histogram.py:35
leaf_histogram`: per-(feature, bin) sums of the (g*w, h*w, w) payload
over the rows of one leaf.  The payload is masked first,
`where(mask, payload, 0.0)`, so rows outside the leaf add +0.0, and then
every row is `index_add_`ed in row order into its feature's bins.  On
the CPU that is the order of JAX's `segment_sum`, so the two agree
bitwise (the tests hold them so).  On a CUDA device `index_add_` adds
with atomics in no fixed order: there the plain version agrees with the
kernel (`ops/hist_kernel.py`) only within the kernel's tolerance.

With quantized gradients, `leaf_histogram_packed(_multi)` (the
reference's `:121-261`, `hist_impl="packed"`) sums the integer lattice
packed two fields to an int32: integer sums, so every device and order
gives the reference's bits.
"""
from __future__ import annotations

import torch


def leaf_histogram(bins_fm: torch.Tensor, payload: torch.Tensor,
                   row_mask: torch.Tensor, max_bin: int) -> torch.Tensor:
    """[F, MB, 3] f32 sums of `payload` [N, 3] over the rows where
    `row_mask` [N] is true, by the bins of `bins_fm` [F, N] (u8/u16)."""
    f, n = bins_fm.shape
    d = torch.where(row_mask[:, None], payload,
                    torch.zeros((), dtype=payload.dtype,
                                device=payload.device))
    offs = torch.arange(f, device=bins_fm.device, dtype=torch.int64)
    flat = (bins_fm.to(torch.int64) + offs[:, None] * max_bin).reshape(-1)
    out = torch.zeros((f * max_bin, 3), dtype=torch.float32,
                      device=payload.device)
    out.index_add_(0, flat, d.repeat(f, 1))
    return out.reshape(f, max_bin, 3)


#: rows per int16-field accumulation tile of the packed histogram
PACKED_TILE = 2048
#: largest num_grad_quant_bins whose per-tile hessian-field sum stays
#: below 2^15 (no carry into the packed gradient field); the booster's
#: quantized-family gate reads it
PACKED_MAX_QUANT_BINS = (2 ** 15 - 1) // PACKED_TILE


def slot_positions(leaf_id: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[N] i64 position of each row's leaf in `slots` (the first match),
    or S for rows whose leaf is not listed (the reference's
    `slot_positions`)."""
    eq = slots.to(leaf_id.dtype)[:, None] == leaf_id[None, :]     # [S, N]
    first = torch.argmax(eq.to(torch.int8), dim=0)
    return torch.where(eq.any(dim=0), first,
                       torch.full_like(first, slots.shape[0]))


def leaf_histogram_packed_multi(bins_fm: torch.Tensor, payload: torch.Tensor,
                                leaf_id: torch.Tensor, slots: torch.Tensor,
                                max_bin: int, s_g: torch.Tensor,
                                s_h: torch.Tensor,
                                const_hess_level: int = 0) -> torch.Tensor:
    """[S, F, MB, 3] f32 quantized-gradient histograms with packed integer
    accumulation (the reference's `ops/histogram.py:206
    leaf_histogram_packed_multi`, the `hist_impl="packed"` path).

    `payload` [N, 3] carries (gq s_g w, hq s_h w, w) with integer gq, hq
    from `quantize_gradients` and w in {0, 1}.  The integers come back by
    division, are packed as gq * 2^16 + hq in int32 and summed per
    PACKED_TILE-row tile into `slot position * MB + bin` cells (a row
    whose leaf is not in `slots` keys to a dropped block), so each tile's
    hessian field stays below 2^15 and never carries into the gradient
    field; then the fields are split and summed over the tiles.  Counts
    are the tiles' sums of int32(w), or, with `const_hess_level` > 0 (a
    declared unit hessian, every live row at hq = level), the hessian
    field's sum divided by the level.  The sums are integers, so any
    order of adds gives these bits: on the CPU they equal the
    reference's, and on the card the CPU's.  Plain PyTorch on any
    device."""
    f, n = bins_fm.shape
    s = slots.shape[0]
    dev = bins_fm.device
    ns = (s + 1) * max_bin
    pos = slot_positions(leaf_id, slots)
    gq = torch.round(payload[:, 0] / s_g).to(torch.int32)
    hq = torch.round(payload[:, 1] / s_h).to(torch.int32)
    if const_hess_level > 0:
        hq = torch.where(hq > 0, const_hess_level, 0).to(torch.int32)
    packed = gq * 65536 + hq
    w = payload[:, 2].to(torch.int32) if const_hess_level == 0 else None
    tiles = -(-n // PACKED_TILE)
    tile_key = (torch.arange(n, device=dev) // PACKED_TILE) * ns \
        + pos * max_bin
    out = torch.empty((f, ns, 3), dtype=torch.float32, device=dev)
    for j in range(f):
        key = tile_key + bins_fm[j].to(torch.int64)
        ph = torch.zeros(tiles * ns, dtype=torch.int32, device=dev)
        ph = ph.index_add_(0, key, packed).view(tiles, ns)
        h_f = ph & 0xFFFF
        g_f = (ph - h_f) >> 16
        h_sum = h_f.sum(dim=0)
        if const_hess_level > 0:
            cnt = h_sum // const_hess_level
        else:
            cnt = torch.zeros(tiles * ns, dtype=torch.int32, device=dev)
            cnt = cnt.index_add_(0, key, w).view(tiles, ns).sum(dim=0)
        out[j] = torch.stack([g_f.sum(dim=0).to(torch.float32) * s_g,
                              h_sum.to(torch.float32) * s_h,
                              cnt.to(torch.float32)], dim=-1)
    return out.view(f, s + 1, max_bin, 3)[:, :s].permute(1, 0, 2, 3) \
        .contiguous()


def leaf_histogram_packed(bins_fm: torch.Tensor, payload: torch.Tensor,
                          row_mask: torch.Tensor, max_bin: int,
                          s_g: torch.Tensor, s_h: torch.Tensor,
                          const_hess_level: int = 0) -> torch.Tensor:
    """[F, MB, 3] f32: `leaf_histogram_packed_multi` of the rows where
    `row_mask` [N] is true (the reference's `leaf_histogram_packed`; its
    integer sums are the same)."""
    lid = torch.where(row_mask, 0, -1).to(torch.int32)
    return leaf_histogram_packed_multi(
        bins_fm, payload, lid, torch.zeros(1, dtype=torch.int32,
                                           device=lid.device),
        max_bin, s_g, s_h, const_hess_level)[0]


# ---- histogram carries: one shard's rows at a time --------------------
#
# The shard-streamed grower (`streaming/engine.py`) never holds the whole
# [F, N] bin matrix: it folds each shard's rows into a histogram carried
# from shard to shard (the reference's `ops/histogram.py:284-382`).
#
#   * f32 family: each shard's rows are `index_add_`ed in row order into
#     the carried cells themselves, never into a zeroed per-shard
#     histogram added afterwards, so with the shards in row order every
#     cell sees the adds of `leaf_histogram` over all rows, in its order;
#   * packed family: int32 sums, each shard cut into PACKED_TILE-row tiles
#     so that a tile's 16-bit hessian field never carries; integer adds
#     give the same totals under any cut into shards and tiles.
#
# `finalize` is the one-pass builders' trailing conversion, so equal
# carries give bit-equal [S, F, MB, 3] histograms.

def hist_stream_init(f: int, slots_n: int, max_bin: int,
                     device=None) -> torch.Tensor:
    """A zero f32 carry [F, (S + 1) * MB, 3] (the reference's
    `hist_stream_init`, whose [3, F, (S + 1) * MB] holds the same cells
    channel-major); block S takes the rows of unlisted leaves."""
    return torch.zeros((f, (slots_n + 1) * max_bin, 3), dtype=torch.float32,
                       device=device)


def hist_stream_update(acc: torch.Tensor, bins_fm: torch.Tensor,
                       payload: torch.Tensor, leaf_id: torch.Tensor,
                       slots: torch.Tensor, max_bin: int) -> torch.Tensor:
    """Fold one shard's rows (`bins_fm` [F, n], `payload` [n, 3],
    `leaf_id` [n]) into the f32 carry in place, in row order; each row
    goes to its leaf's first position in `slots`."""
    f, n = bins_fm.shape
    ns = acc.shape[1]
    pos = slot_positions(leaf_id, slots)
    offs = torch.arange(f, device=bins_fm.device, dtype=torch.int64)
    flat = (bins_fm.to(torch.int64) + (pos * max_bin)[None, :]
            + offs[:, None] * ns).reshape(-1)
    acc.view(f * ns, 3).index_add_(0, flat, payload.repeat(f, 1))
    return acc


def hist_stream_finalize(acc: torch.Tensor, slots_n: int,
                         max_bin: int) -> torch.Tensor:
    """The f32 carry as [S, F, MB, 3] (the reference's
    `hist_stream_finalize`)."""
    f = acc.shape[0]
    return acc.view(f, slots_n + 1, max_bin, 3)[:, :slots_n] \
        .permute(1, 0, 2, 3).contiguous()


def hist_stream_packed_init(f: int, slots_n: int, max_bin: int,
                            const_hess_level: int = 0,
                            device=None) -> dict:
    """Zero int32 carries {"g", "h"[, "c"]} of [F, (S + 1) * MB] (the
    reference's `hist_stream_packed_init`); no count carry when the
    counts derive from the hessian field."""
    ns = (slots_n + 1) * max_bin
    acc = {k: torch.zeros((f, ns), dtype=torch.int32, device=device)
           for k in ("g", "h")}
    if const_hess_level == 0:
        acc["c"] = torch.zeros((f, ns), dtype=torch.int32, device=device)
    return acc


def hist_stream_packed_update(acc: dict, bins_fm: torch.Tensor,
                              payload: torch.Tensor, leaf_id: torch.Tensor,
                              slots: torch.Tensor, max_bin: int, s_g, s_h,
                              const_hess_level: int = 0) -> dict:
    """Fold one shard's rows into the packed int32 carries in place (the
    reference's `hist_stream_packed_update`): the shard's lattice packed
    gq * 2^16 + hq, summed per PACKED_TILE-row tile of the shard, the
    fields split and summed over the tiles, then added to the carries."""
    f, n = bins_fm.shape
    dev = bins_fm.device
    ns = acc["g"].shape[1]
    pos = slot_positions(leaf_id, slots)
    gq = torch.round(payload[:, 0] / s_g).to(torch.int32)
    hq = torch.round(payload[:, 1] / s_h).to(torch.int32)
    if const_hess_level > 0:
        hq = torch.where(hq > 0, const_hess_level, 0).to(torch.int32)
    packed = gq * 65536 + hq
    w = payload[:, 2].to(torch.int32) if const_hess_level == 0 else None
    tiles = -(-n // PACKED_TILE)
    tile_key = (torch.arange(n, device=dev) // PACKED_TILE) * ns \
        + pos * max_bin
    for j in range(f):
        key = tile_key + bins_fm[j].to(torch.int64)
        ph = torch.zeros(tiles * ns, dtype=torch.int32, device=dev)
        ph = ph.index_add_(0, key, packed).view(tiles, ns)
        h_f = ph & 0xFFFF
        acc["g"][j] += ((ph - h_f) >> 16).sum(dim=0, dtype=torch.int32)
        acc["h"][j] += h_f.sum(dim=0, dtype=torch.int32)
        if w is not None:
            c = torch.zeros(tiles * ns, dtype=torch.int32, device=dev)
            acc["c"][j] += c.index_add_(0, key, w).view(tiles, ns) \
                .sum(dim=0, dtype=torch.int32)
    return acc


def hist_stream_packed_finalize(acc: dict, slots_n: int, max_bin: int,
                                s_g, s_h,
                                const_hess_level: int = 0) -> torch.Tensor:
    """The packed carries as [S, F, MB, 3] f32 (the reference's
    `hist_stream_packed_finalize`, `leaf_histogram_packed_multi`'s
    conversion)."""
    f = acc["g"].shape[0]
    h_sum = acc["h"]
    cnt = h_sum // const_hess_level if const_hess_level > 0 else acc["c"]
    out = torch.stack([acc["g"].to(torch.float32) * s_g,
                       h_sum.to(torch.float32) * s_h,
                       cnt.to(torch.float32)], dim=-1)
    return out.view(f, slots_n + 1, max_bin, 3)[:, :slots_n] \
        .permute(1, 0, 2, 3).contiguous()
