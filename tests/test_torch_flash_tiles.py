"""The tile schedule of kernels E and F (`ops.flash_attention.tile_schedule`), on the CPU.

The kernels visit a (64-query tile, 64-key tile) pair inside the causal and
window range only when the two tiles' intervals of real segment ids meet or
both tiles hold padding; `tile_schedule` is that predicate in PyTorch. Here,
on numpy-seeded segment layouts, every allowed (query, key) pair of
`attention_mask` must lie in a visited tile, whatever the ids; with ids that
do not decrease along a row (as the packing writes them) and no window, every
visited tile must hold an allowed pair. On the packed batch of
``chip_smoke.py``'s phase 8 (``data.synthetic.packed_batch(serving_config(),
512, 8, 1024)``, padding as ``-1``) the visited share of
the causal tiles is 0.418 without a window and 0.748 with a window of 256.
"""

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu_torch.ops.flash_attention import TILE, attention_mask, tile_schedule

B, S = 3, 512
N = S // TILE


def segments(layout: str, seed: int = 0) -> torch.Tensor:
    """``(B, S)`` int32 segment ids of one layout (padding as -1)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        if layout == "single":
            continue
        if layout == "per_event":  # one event a segment, then padding
            seg[b] = np.arange(S)
            seg[b, S - int(rng.integers(1, 50)) :] = -1
            continue
        if layout == "boundary":  # segments starting exactly on tile boundaries
            cuts = np.sort(rng.choice(np.arange(1, N), size=3, replace=False)) * TILE
        else:
            cuts = np.sort(rng.choice(np.arange(8, S - 60), size=int(rng.integers(1, 5)), replace=False))
        for i, c in enumerate(cuts):
            seg[b, c:] = i + 1
        seg[b, S - int(rng.integers(1, 50)) :] = -1
        if layout == "unordered":  # real ids permuted: not monotone along the row
            ids = rng.permutation(len(cuts) + 1) * 7 + 2
            seg[b] = np.where(seg[b] >= 0, ids[np.maximum(seg[b], 0)], -1)
        elif layout == "padmid":  # a run of padding inside the row
            start = int(rng.integers(30, S // 2))
            seg[b, start : start + int(rng.integers(10, 150))] = -1
        elif layout == "all_pad" and b == 1:  # a row of padding only
            seg[b] = -1
    return torch.from_numpy(seg)


def tiles_with_allowed_pairs(seg: torch.Tensor, window) -> torch.Tensor:
    """``(B, N, N)``: the tile pairs holding at least one allowed (query, key) pair."""
    return attention_mask(seg, window)[:, 0].reshape(seg.shape[0], N, TILE, N, TILE).any(-1).any(2)


def causal_tiles(window, n=N) -> torch.Tensor:
    """The tile pairs inside the causal and window range, written out here
    independently of the module: ``kt <= qt`` and the last key of ``kt``
    within the window of the first query of ``qt``."""
    qt, kt = torch.arange(n)[:, None], torch.arange(n)[None, :]
    mask = kt <= qt
    if window is not None:
        mask = mask & ((kt + 1) * TILE - 1 >= qt * TILE - window + 1)
    return mask


LAYOUTS = ["packed", "unordered", "padmid", "single", "per_event", "boundary", "all_pad"]
MONOTONE = ["packed", "single", "per_event", "boundary", "all_pad"]


@pytest.mark.parametrize("window", [None, 40, 160, 1000])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_allowed_pairs_lie_in_visited_tiles(layout, window):
    seg = segments(layout)
    visited = tile_schedule(seg, window)
    assert visited.shape == (B, N, N) and visited.dtype == torch.bool
    needed = tiles_with_allowed_pairs(seg, window)
    assert bool((needed <= visited).all()), (needed & ~visited).nonzero()
    assert not bool((visited & ~causal_tiles(window)).any()), "a visited tile lies outside the causal/window range"
    assert bool(visited.diagonal(dim1=1, dim2=2).all()), "every query tile visits its own diagonal tile"


@pytest.mark.parametrize("layout", MONOTONE)
def test_schedule_is_tight_for_non_decreasing_ids(layout):
    """Without a window, ids that do not decrease (padding at the row's end)
    make every visited tile one that holds an allowed pair."""
    seg = segments(layout, seed=1)
    assert torch.equal(tile_schedule(seg), tiles_with_allowed_pairs(seg, None))


def test_schedule_matches_the_per_tile_predicate():
    """The vectorised schedule against the predicate written tile by tile."""
    for layout in LAYOUTS:
        seg = segments(layout, seed=2)
        for window in (None, 160):
            got = tile_schedule(seg, window)
            for b in range(B):
                for qt in range(N):
                    for kt in range(N):
                        a, c = seg[b, qt * TILE : (qt + 1) * TILE], seg[b, kt * TILE : (kt + 1) * TILE]
                        ra, rc = a[a >= 0], c[c >= 0]
                        meet = len(ra) > 0 and len(rc) > 0 and max(ra.min(), rc.min()) <= min(ra.max(), rc.max())
                        want = bool(causal_tiles(window)[qt, kt]) and (meet or bool((a < 0).any() and (c < 0).any()))
                        assert bool(got[b, qt, kt]) == want, (layout, window, b, qt, kt)


@pytest.fixture(scope="module")
def phase8_segments():
    """The segment ids kernel E gets on ``chip_smoke.py``'s phase-8 batch."""
    from eventstreamgpt_tpu_torch.data.synthetic import packed_batch, serving_config

    batch = packed_batch(serving_config(), 512, 8, 1024)
    return torch.where(batch.event_mask, batch.segment_ids.to(torch.int32), -1)


@pytest.mark.parametrize("window,share", [(None, 0.418), (256, 0.748)])
def test_phase8_batch_visited_share(phase8_segments, window, share):
    seg = phase8_segments
    n = seg.shape[1] // TILE
    visited = tile_schedule(seg, window)
    got = visited.sum().item() / (causal_tiles(window, n).sum().item() * seg.shape[0])
    assert abs(got - share) <= 0.01, got
    needed = attention_mask(seg, window)[:, 0].reshape(seg.shape[0], n, TILE, n, TILE).any(-1).any(2)
    assert bool((needed <= visited).all())
    if window is None:
        assert torch.equal(visited, needed)  # the packing's ids do not decrease: nothing extra is visited
