"""The finish kernel's order (csrc/finish.cu, ops/finish.py
``tally_twin``) on the CPU, no card needed.

The kernel adds a segment's finished lanes into the four binned escape
tallies (the two escape PSDs, esc_energy_eff, esc_num_eff) in a fixed
order of its own; ``tally_twin`` is the same sums in the same order in
plain torch, and tests/test_torch_cuda.py holds the kernel to it bit for
bit on a card.  Here:

* the twin against today's CPU path (``tally_index_put``, accumulating
  ``index_put_``, serial in lane order) within TOL of each cell's value,
  on the benchmark cell's tallies (54 x 41 cells) at 65,536 lanes: every
  lane in one cell, both reasons mixed over the whole histogram, the 1-D
  tallies alone, a lane count that is no multiple of the chunk, onto
  tallies that already hold sums;
* every addend zero (a dead segment's lanes) leaves the tallies' bits
  as they were; moving the zero-addend lanes to other cells leaves the
  twin's bits the same;
* the twin against a loop that does what the kernel's two kernels do,
  thread by thread and block by block (the level-0 merge, the stable
  sort, the runs, the chunks in order), bit for bit;
* the twin's constants are the kernel's, and the wrapper refuses what
  the kernel does not take before any launch.

TOL (tests/torch_finish_cases.py): both sum the same nonnegative float64 addends, so each cell's
difference is at most (n_c + d) u of its value to first order, n_c the
cell's addends (index_put_'s chain), d the kernel's depth (its lane
group, its chunk's groups and the chunks: 3 + 255 + 64 at 65,536
lanes), u = 2^-53: 7.3e-12 in the worst case of 65,536 lanes in one
cell, where rounding errors cancel: the cases here read 4.7e-14 at
most.  TOL is the rebinning kernel's 1e-12.
"""

import re

import pytest
import torch

from montecarloscattering_jl_tpu_torch.ops import build
from montecarloscattering_jl_tpu_torch.ops import finish as fin

from torch_finish_cases import (BINNED, CASES, LANES, N_MOM1, N_THETA1,
                                assert_close, lanes, run, same_bits, tallies)


@pytest.mark.parametrize("start", [None, 3], ids=["fresh", "holding"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_index_put(case, start):
    kw = dict(CASES[case])
    x = lanes(kw.pop("n"), seed=len(case), **kw)
    want = run(fin.tally_index_put, x, start)
    got = run(fin.tally_twin, x, start)
    assert_close(got, want)
    # each case reaches the tallies of its reasons
    before = run(lambda acc, **_: None, x, start)
    moved = {f for f in BINNED if not torch.equal(got[f], before[f])}
    assert moved == set(BINNED[1:] if kw.get("reasons") == (2,)
                        else BINNED)


@pytest.mark.parametrize("start", [None, 3], ids=["fresh", "holding"])
def test_dead_segment_leaves_the_bits(start):
    """A dead segment's lanes all have zero weight: every addend is 0."""
    x = lanes(LANES, seed=11)
    for k in ("wwf", "we", "wd"):
        x[k] = torch.zeros_like(x[k])
    before = run(lambda acc, **_: None, x, start)
    assert same_bits(run(fin.tally_twin, x, start), before)
    assert same_bits(run(fin.tally_index_put, x, start), before)


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_addends_anywhere_give_the_same_bits(seed):
    """The zero-addend lanes (not finished, padding, a reason's other
    tallies) moved to other cells, or to one cell, or their flags
    changed: the twin's bits stay."""
    x = lanes(LANES, seed=seed)
    ref = run(fin.tally_twin, x)
    zero = x["wd"] == 0
    g = torch.Generator().manual_seed(seed)
    for ip, jt in ((torch.randint(0, N_MOM1, (LANES,), generator=g),
                    torch.randint(0, N_THETA1, (LANES,), generator=g)),
                   (torch.zeros(LANES, dtype=torch.int64),
                    torch.zeros(LANES, dtype=torch.int64))):
        y = dict(x, ip=torch.where(zero, ip, x["ip"]),
                 jt=torch.where(zero, jt, x["jt"]),
                 is_up=torch.where(zero, True, x["is_up"]))
        assert same_bits(run(fin.tally_twin, y), ref)


def _kernel_loop(acc, ip, jt, is_dw, is_up, wwf, we, wd):
    """csrc/finish.cu step by step: kernel 1's threads and blocks, then
    kernel 2's chunks in order."""
    n = ip.shape[0]
    n_mom1, n_theta1 = acc.esc_psd_dw.shape
    cells = n_mom1 * n_theta1
    sentinel = 2 * cells + n_mom1
    k_lanes, k_chunk = fin.GROUP_LANES, fin.CHUNK_LANES
    chunks = []
    for c0 in range(0, n, k_chunk):
        slots = []                       # (key, [x, y]) in thread order
        for t0 in range(c0, min(c0 + k_chunk, n), k_lanes):
            mine = [[sentinel, [0.0, 0.0]] for _ in range(2 * k_lanes)]
            for i in range(k_lanes):
                lane = t0 + i
                if lane >= n or not (is_up[lane] or is_dw[lane]):
                    continue
                cell = int(ip[lane]) * n_theta1 + int(jt[lane])
                if float(wwf[lane]) != 0.0:
                    mine[i] = [cell + (cells if is_up[lane] else 0),
                               [float(wwf[lane]), 0.0]]
                if is_up[lane] and (float(we[lane]) != 0.0
                                    or float(wd[lane]) != 0.0):
                    mine[k_lanes + i] = [2 * cells + int(ip[lane]),
                                         [float(we[lane]), float(wd[lane])]]
            for i in range(1, len(mine)):
                for j in range(i):
                    if mine[i][0] != sentinel and mine[j][0] == mine[i][0]:
                        mine[j][1] = [mine[j][1][0] + mine[i][1][0],
                                      mine[j][1][1] + mine[i][1][1]]
                        mine[i][0] = sentinel
            slots += mine
        runs = {}
        for key, (x, y) in sorted(slots, key=lambda s: s[0]):  # stable
            if key == sentinel:
                continue
            if key in runs:
                runs[key] = [runs[key][0] + x, runs[key][1] + y]
            else:
                runs[key] = [x, y]
        chunks.append(runs)
    psd = (acc.esc_psd_dw.view(-1), acc.esc_psd_up.view(-1))
    for runs in chunks:
        for key, (x, y) in runs.items():
            if key < 2 * cells:
                psd[key // cells][key % cells] += x
            else:
                acc.esc_energy_eff[key - 2 * cells] += x
                acc.esc_num_eff[key - 2 * cells] += y


@pytest.mark.parametrize("n,cells", [(3 * 1024 + 77, None),
                                     (2048, [(3, 4), (3, 5), (9, 0)])],
                         ids=["spread", "crowded"])
def test_twin_is_the_kernels_order(n, cells):
    x = lanes(n, seed=n, share_fin=0.6, cells=cells)
    assert same_bits(run(fin.tally_twin, x, 5), run(_kernel_loop, x, 5))


def test_twin_constants_are_the_kernels():
    src = (build.CSRC / "finish.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kLanes"]) == fin.GROUP_LANES
    assert int(const["kThreads"]) * fin.GROUP_LANES == fin.CHUNK_LANES
    assert fin.CHUNK_SLOTS == 2 * fin.CHUNK_LANES
    assert "finish" in build.LIBRARIES


def test_scratch_is_sized_from_the_lanes():
    for n, chunks in ((1, 1), (1024, 1), (1025, 2), (LANES, 64)):
        s = fin.FinishScratch.for_lanes(n, "cpu")
        assert s.counts.shape == (chunks,)
        assert s.keys.shape == (chunks * fin.CHUNK_SLOTS,)
        assert s.vals.shape == (chunks * fin.CHUNK_SLOTS, 2)


def test_wrapper_raises_before_any_launch():
    x = lanes(1500, seed=2)
    acc = tallies()
    s = fin.FinishScratch.for_lanes(1500, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        fin.tally_escapes(acc, **x, scratch=s)
    with pytest.raises(ValueError, match="dtype"):
        fin.tally_escapes(acc, **dict(x, ip=x["ip"].int()), scratch=s)
    with pytest.raises(ValueError, match="shape"):
        fin.tally_escapes(acc, **dict(x, wd=x["wd"][:-1]), scratch=s)
    with pytest.raises(ValueError, match="contiguous"):
        fin.tally_escapes(acc, **dict(x, wwf=torch.stack(
            [x["wwf"], x["wwf"]], 1)[:, 0]), scratch=s)
    with pytest.raises(ValueError, match="scratch"):
        fin.tally_escapes(acc, **x, scratch=None)
    with pytest.raises(ValueError, match="scratch: 1 chunks"):
        fin.tally_escapes(acc, **x,
                          scratch=fin.FinishScratch.for_lanes(1000, "cpu"))
    assert fin.LAUNCHES == 0
