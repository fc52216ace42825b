"""K3's plan, on the CPU: which tiles a CTA of the one-launch chain takes
and in what order, what each tile reads of the conv before it, and whether
the block's residual stays in shared memory
(``ops/kernels/resblock_chain_fused.py``). The kernel derives the same
from its shape and grid; here the plan is held against the plain version
and against the JAX package's whole-chain Pallas kernel in interpret mode.

``fused_resblock_chain_tiled`` runs the chain one tile at a time in a given
order, in place on one activation and one h buffer. An order that respects
every tile's dependency set must give the plain result; one that breaks a
dependency must not.

Tolerance: float32 throughout; the tiled run convolves each tile's haloed
box on its own where the plain version convolves the image, and the Pallas
kernel sums nine shifted products, so they differ by the order of summation:
1e-4 absolute and relative, as tests/test_torch_port_kernels.py states it
for the chain.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from megaportraits_tpu.ops.pallas.g2d_chain import fused_resblock_chain

from megaportraits_tpu_torch.ops.kernels import conv3x3 as k1
from megaportraits_tpu_torch.ops.kernels import resblock_chain_fused as k3

from torch_port_utils import n, t

TOL = dict(atol=1e-4, rtol=1e-4)
SMS = 132  # CTAs an H100 holds at once, one an SM

# (h, w, c, grid): the trunk with one tile a CTA; ragged shapes on the tap
# path and the haloed path; shapes with several tiles a CTA, evenly and not.
SHAPES = [(64, 64, 512, 128), (40, 24, 256, 20), (9, 65, 96, 10),
          (128, 128, 256, SMS), (64, 64, 512, 50), (40, 24, 256, 7),
          (16, 16, 128, 1)]


def _chain_inputs(seed, h, w, c, nb):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h, w, c)).astype(np.float32)
    wts = (rng.normal(size=(nb, 2, 3, 3, c, c)) * 0.05).astype(np.float32)
    sc = rng.uniform(0.8, 1.2, (nb, 2, c)).astype(np.float32)
    sh = (rng.normal(size=(nb, 2, c)) * 0.05).astype(np.float32)
    return x, wts, sc, sh


def _run_ctas(h, w, c, n_blocks, grid, pick):
    """Runs the schedule's CTAs side by side: a CTA may take its next step
    when every step that one reads is done. `pick(ready)` chooses which of
    the ready CTAs moves. Returns the order taken; fails if no CTA can move
    before all are through (a deadlock)."""
    schedule = k3.chain_schedule(h, w, c, n_blocks, grid)
    deps = {step: k3.tile_dependencies(h, w, c, *step)
            for steps in schedule for step in steps}
    pos = [0] * grid
    done, order = set(), []
    total = sum(len(steps) for steps in schedule)
    while len(order) < total:
        ready = [cta for cta in range(grid) if pos[cta] < len(schedule[cta])
                 and deps[schedule[cta][pos[cta]]] <= done]
        assert ready, f"deadlock after {len(order)} of {total} steps"
        cta = pick(ready)
        step = schedule[cta][pos[cta]]
        pos[cta] += 1
        done.add(step)
        order.append(step)
    return order


def _random_pick(seed):
    rng = np.random.default_rng(seed)
    return lambda ready: ready[rng.integers(len(ready))]


def _check_schedule(h, w, c, n_blocks, grid):
    tiles = k3.conv_tiles(h, w, c)
    schedule = k3.chain_schedule(h, w, c, n_blocks, grid)
    assert len(schedule) == grid and all(schedule)  # no CTA is idle
    taken = [step for steps in schedule for step in steps]
    assert sorted(taken) == [(k, ti) for k in range(2 * n_blocks)
                             for ti in range(tiles)]  # each once
    for steps in schedule:
        convs = [k for k, _ in steps]
        assert convs == sorted(convs)  # all of conv k before any of conv k + 1
        per_conv = [[ti for k, ti in steps if k == conv]
                    for conv in range(2 * n_blocks)]
        assert all(p == per_conv[0] for p in per_conv)  # the same tiles each conv
    assert k3.residual_stays_in_shared(h, w, c, grid) == all(
        len(steps) == 2 * n_blocks for steps in schedule)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_of_every_conv_is_taken_once(shape):
    _check_schedule(*shape[:3], 3, shape[3])


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 90), st.integers(1, 140), st.integers(1, 40),
       st.integers(1, 3), st.integers(1, SMS))
def test_every_tile_is_taken_once_sweep(h, w, c8, n_blocks, resident):
    c = 8 * c8
    _check_schedule(h, w, c, n_blocks, k3.plan_grid(h, w, c, resident))


def test_plan_of_the_trunk_shape():
    h, w, c = 64, 64, 512
    assert k1.tile_box(h, w) == (2, 64)
    assert k3.conv_tiles(h, w, c) == 128  # 32 pixel boxes x 4 channel tiles
    assert k3.plan_grid(h, w, c, SMS) == 128
    assert k3.residual_stays_in_shared(h, w, c, 128)
    assert not k3.residual_stays_in_shared(h, w, c, 64)
    assert k3.tile_dependencies(h, w, c, 0, 5) == set()
    # conv1 of block 1, pixel box 5, channel tile 2: boxes 4, 5, 6 of the
    # conv before at all 4 channel tiles.
    want = {(1, nt * 32 + box) for nt in range(4) for box in (4, 5, 6)}
    assert k3.tile_dependencies(h, w, c, 2, 2 * 32 + 5) == want
    # conv2 of block 1 adds its own tile of block 0's conv2 as well; conv2
    # of block 0 adds x, which no step writes.
    deps = k3.tile_dependencies(h, w, c, 3, 2 * 32 + 5)
    assert deps == {(2, ti) for _, ti in want} | {(1, 2 * 32 + 5)}
    assert len(k3.tile_dependencies(h, w, c, 1, 0)) == 8  # boxes 0 and 1
    # More tiles than the card holds CTAs: 128x128x256 has 256.
    assert k3.plan_grid(128, 128, 256, SMS) == SMS
    assert not k3.residual_stays_in_shared(128, 128, 256, SMS)
    with pytest.raises(ValueError):
        k3.plan_grid(h, w, c, 0)
    with pytest.raises(ValueError):
        k3.chain_schedule(h, w, c, 1, 129)
    with pytest.raises(ValueError):
        k3.tile_dependencies(h, w, c, 1, 128)


def _check_dependencies(h, w, c, n_convs=4):
    """Each step reads exactly the tiles whose pixel box, grown by the
    one-pixel halo, meets its own; and whoever reads the tile a step
    overwrites (the same tile two convs earlier, in place) is among the
    steps it waits for."""
    bh, bw = k1.tile_box(h, w)
    origins = k1.tile_origins(h, w)
    tiles = k3.conv_tiles(h, w, c)
    deps = {(k, ti): k3.tile_dependencies(h, w, c, k, ti)
            for k in range(n_convs) for ti in range(tiles)}
    for (k, ti), got in deps.items():
        y0, x0 = origins[ti % len(origins)]
        want = set()
        if k > 0:
            for tj in range(tiles):
                yj, xj = origins[tj % len(origins)]
                if (yj < min(y0 + bh, h) + 1 and y0 - 1 < min(yj + bh, h)
                        and xj < min(x0 + bw, w) + 1 and x0 - 1 < min(xj + bw, w)):
                    want.add((k - 1, tj))
        if k % 2 == 1 and k >= 3:
            want.add((k - 2, ti))
        assert got == want, (k, ti)
    for (k, ti), got in deps.items():
        if k < 2:
            continue
        readers = {step for step, d in deps.items() if (k - 2, ti) in d}
        assert readers - {(k, ti)} <= got, (k, ti)


@pytest.mark.parametrize("shape", [(64, 64, 512), (40, 24, 256), (9, 65, 96),
                                   (20, 130, 136), (3, 7, 8)])
def test_dependency_sets_are_the_haloed_neighbours(shape):
    _check_dependencies(*shape)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(1, 40), st.integers(1, 140), st.integers(1, 40))
def test_dependency_sets_sweep(h, w, c8):
    _check_dependencies(h, w, 8 * c8)


# (h, w, c, blocks, grid): the tap path and the haloed path, ragged, one and
# several tiles a CTA.
TILED = [(40, 24, 256, 2, 20), (40, 24, 256, 2, 7), (9, 65, 96, 2, 10),
         (9, 65, 96, 3, 4), (12, 20, 40, 2, 3)]


@pytest.mark.parametrize("case", TILED)
def test_tiles_in_a_random_allowed_order_match_plain(case):
    h, w, c, nb, grid = case
    args = [t(a) for a in _chain_inputs(40, h, w, c, nb)]
    want = k3.fused_resblock_chain_plain(*args)
    for seed in (0, 1):
        order = _run_ctas(h, w, c, nb, grid, _random_pick(seed))
        keep = k3.residual_stays_in_shared(h, w, c, grid)
        got = k3.fused_resblock_chain_tiled(*args, order, keep_residual=keep)
        np.testing.assert_allclose(n(got), n(want), **TOL)
    assert not torch.equal(args[0], want)  # x is never written


def test_tiles_in_a_random_allowed_order_match_pallas_interpret():
    """24x72x256, N=2: 24 pixel boxes (haloed, the last column ragged) by 2
    channel tiles; in place with the residual kept, and with it re-read."""
    h, w, c, nb = 24, 72, 256, 2
    x, wts, sc, sh = _chain_inputs(41, h, w, c, nb)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_resblock_chain(
            jnp.asarray(x), jnp.asarray(wts), jnp.asarray(sc), jnp.asarray(sh)))
    args = (t(x), t(wts), t(sc), t(sh))
    for grid, seed in ((48, 2), (13, 3)):
        order = _run_ctas(h, w, c, nb, grid, _random_pick(seed))
        got = k3.fused_resblock_chain_tiled(
            *args, order,
            keep_residual=k3.residual_stays_in_shared(h, w, c, grid))
        np.testing.assert_allclose(n(got), want, **TOL)


@pytest.mark.parametrize("conv", [1, 2, 3])
def test_an_order_that_breaks_a_dependency_gives_another_result(conv):
    """A step of `conv` moved ahead of one neighbouring tile that it reads
    finds that tile as the buffer held it before: the check can fail."""
    h, w, c, nb, grid = 40, 24, 256, 2, 20
    args = [t(a) for a in _chain_inputs(42, h, w, c, nb)]
    want = k3.fused_resblock_chain_plain(*args)
    order = _run_ctas(h, w, c, nb, grid, _random_pick(4))
    step = (conv, 3)
    needed = min(d for d in k3.tile_dependencies(h, w, c, *step)
                 if d[0] == conv - 1 and d[1] % 10 != 3)  # a neighbour's box
    broken = [s for s in order if s != step]
    broken.insert(broken.index(needed), step)
    assert sorted(broken) == sorted(order)
    got = k3.fused_resblock_chain_tiled(*args, broken)
    assert (got - want).abs().max().item() > 1e-2
    # The order it came from is fine.
    np.testing.assert_allclose(
        n(k3.fused_resblock_chain_tiled(*args, order)), n(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_the_fixed_order_of_each_cta_never_deadlocks(shape):
    """Whichever ready CTA moves next (a random one, always the first,
    always the last, the one furthest behind), all steps get done."""
    h, w, c, grid = shape
    picks = [_random_pick(5), lambda ready: ready[0], lambda ready: ready[-1]]
    for pick in picks:
        order = _run_ctas(h, w, c, 2, grid, pick)
        assert len(set(order)) == len(order) == 4 * k3.conv_tiles(h, w, c)


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(1, 40), st.integers(1, 140), st.integers(1, 32),
       st.integers(1, 40), st.integers(0, 2 ** 16))
def test_no_deadlock_sweep(h, w, c8, resident, seed):
    c = 8 * c8
    grid = k3.plan_grid(h, w, c, resident)
    order = _run_ctas(h, w, c, 2, grid, _random_pick(seed))
    done = set()
    for step in order:  # and the order respects every dependency
        assert k3.tile_dependencies(h, w, c, *step) <= done
        done.add(step)
