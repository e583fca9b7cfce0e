"""The port's optimizer pieces (`tpufusion_torch/train/optim.py`) against
the optax pieces the reference trainers are built from, on identical
gradient sequences: numpy gradients made from a seed go through
`optax.adam` / `cosine_decay_schedule` / `MultiSteps` /
`contrib.reduce_on_plateau` and through `Adam` / `cosine_decay_schedule` /
`every_k` / `ReduceOnPlateau`. Tolerance: parameters within 1e-6 after
each of 20 steps (float32 on both sides); learning rates within 1e-9
relative; the plateau rule's scale equal, not close, after every value.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpufusion_torch.train.optim import Adam, ReduceOnPlateau, cosine_decay_schedule

STEPS = 20
ATOL = 1e-6
SHAPES = [(5, 5, 3, 4), (4,), (7, 3)]


def _sequence(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    # gradient scales from 1e-4 to 10, and one exactly-zero gradient entry
    grads = [[(rng.normal(size=s) * 10 ** rng.uniform(-4, 1)).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    grads[3][1][0] = 0.0
    return params, grads


def _run_both(tx, make, values=None, seed=0):
    """Feeds one gradient sequence to the optax transform `tx` and to the
    port's optimizer `make(params)`; returns (largest parameter difference
    after each step, the optax state, the optimizer, the port's parameters
    after each step)."""
    p0, grads = _sequence(seed)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make(tparams)
    diffs, trail = [], []
    for i, g in enumerate(grads):
        kw = {} if values is None else {"value": jnp.asarray(values[i])}
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params, **kw)
        params = optax.apply_updates(params, updates)
        for t, x in zip(tparams, g):
            t.grad = torch.from_numpy(x.copy())
        opt.step(None if values is None else torch.tensor(values[i]))
        diffs.append(max(float(np.abs(np.asarray(a) - t.detach().numpy()).max())
                         for a, t in zip(params, tparams)))
        trail.append([t.detach().numpy().copy() for t in tparams])
    return diffs, state, opt, trail


@pytest.mark.parametrize("lr", [1e-3, 3e-3])
def test_adam_matches_optax(lr):
    diffs, _, opt, _ = _run_both(optax.adam(lr), lambda p: Adam(p, lr))
    assert max(diffs) <= ATOL, diffs
    assert opt.count == STEPS


def test_adam_first_step_moves_by_lr_whatever_the_gradient_scale():
    """After one step the update is lr * g / (|g| + 1e-8): every entry with
    a gradient moves by lr, a zero gradient by nothing (why parameters of
    two frameworks are never compared after a step from independently
    computed gradients)."""
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([1e-6, -3.0, 0.0, 250.0])
    Adam([p], 1e-3).step()
    np.testing.assert_allclose(p.detach().numpy(), [-1e-3, 1e-3, 0.0, -1e-3], rtol=2e-2)


@pytest.mark.parametrize("decay_steps, alpha", [(12, 0.01), (6, 1e-3), (40, 0.0)])
def test_cosine_schedule_matches_optax(decay_steps, alpha):
    lr = 3e-3
    schedule = optax.cosine_decay_schedule(lr, decay_steps, alpha)

    def make(p):
        opt = Adam(p, lr)
        cosine_decay_schedule(opt, decay_steps, alpha)
        return opt

    p0, grads = _sequence()
    opt = make([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0])
    for n in range(STEPS):
        assert opt.scheduler.get_last_lr()[0] == pytest.approx(float(schedule(n)), rel=1e-6)
        for group in opt.param_groups:
            for t, g in zip(group["params"], grads[n]):
                t.grad = torch.from_numpy(g)
        opt.step()
    if decay_steps < STEPS:  # flat at alpha * lr beyond the horizon
        assert opt.scheduler.get_last_lr()[0] == pytest.approx(alpha * lr, rel=1e-6)
    diffs, *_ = _run_both(optax.adam(schedule), make)
    assert max(diffs) <= ATOL, diffs


def test_cosine_schedule_is_not_torchs_cosine_annealing():
    """torch's CosineAnnealingLR rises again after T_max; the reference's
    schedule (and the port's) stays at alpha * init."""
    p = [torch.nn.Parameter(torch.zeros(1))]
    opt = Adam(p, 1.0)
    cosine_decay_schedule(opt, 4, 0.1)
    other = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    annealing = torch.optim.lr_scheduler.CosineAnnealingLR(other, T_max=4, eta_min=0.1)
    for _ in range(8):
        p[0].grad = torch.ones(1)
        opt.step()
        other.step()
        annealing.step()
    assert opt.scheduler.get_last_lr()[0] == pytest.approx(0.1)
    assert annealing.get_last_lr()[0] > 0.9  # back at the top
    with pytest.raises(ValueError, match="decay_steps"):
        cosine_decay_schedule(opt, 0)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_multisteps(k):
    lr = 3e-3
    diffs, state, opt, trail = _run_both(
        optax.MultiSteps(optax.adam(lr), k), lambda p: Adam(p, lr, every_k=k))
    assert max(diffs) <= ATOL, diffs
    assert opt.count == STEPS // k == int(state.gradient_step)
    assert opt.mini_step == STEPS % k == int(state.mini_step)
    for i in range(1, STEPS):  # no parameter change between the updates
        moved = any((a != b).any() for a, b in zip(trail[i], trail[i - 1]))
        assert moved == ((i + 1) % k == 0), i


def test_accumulation_counts_the_schedule_in_updates():
    lr, k = 3e-3, 2

    def make(p):
        opt = Adam(p, lr, every_k=k)
        cosine_decay_schedule(opt, 6, 0.01)
        return opt

    tx = optax.MultiSteps(optax.adam(optax.cosine_decay_schedule(lr, 6, 0.01)), k)
    diffs, _, opt, _ = _run_both(tx, make)
    assert max(diffs) <= ATOL, diffs
    assert opt.scheduler.last_epoch == STEPS // k
    with pytest.raises(ValueError, match="every_k"):
        Adam([torch.nn.Parameter(torch.zeros(1))], every_k=0)


# plateaus, improves inside the cooldown, plateaus again
PLATEAU_VALUES = np.array(
    [5, 4, 3, 3, 3, 3, 3, 3, 3, 3, 2.5, 3, 3, 3, 3, 3, 3, 3, 3, 3], np.float32)


@pytest.mark.parametrize("kw", [
    dict(patience=2, factor=0.5, accumulation_size=2, cooldown=1),
    dict(patience=3, factor=0.5, accumulation_size=1, cooldown=1),  # the fusion trainer's rule
    dict(patience=1, factor=0.1, accumulation_size=3, cooldown=0, min_scale=0.05),
    dict(patience=2, factor=0.5, accumulation_size=1, cooldown=2, rtol=0.0, atol=0.2),
])
def test_plateau_matches_optax(kw):
    lr = 1e-2
    tx = optax.chain(optax.adam(lr), optax.contrib.reduce_on_plateau(**kw))
    p0, grads = _sequence()
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = Adam(tparams, lr, plateau=ReduceOnPlateau(**kw, device="cpu"))
    scales = []
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params,
                                   value=jnp.asarray(PLATEAU_VALUES[i]))
        params = optax.apply_updates(params, updates)
        for t, x in zip(tparams, g):
            t.grad = torch.from_numpy(x.copy())
        opt.step(torch.tensor(PLATEAU_VALUES[i]))
        want, got = state[1], opt.plateau
        scales.append(float(got.scale))
        # equal, not close: the scale, the counts and the best value
        assert float(got.scale) == float(want.scale), i
        assert int(got.plateau_count) == int(want.plateau_count), i
        assert int(got.cooldown_count) == int(want.cooldown_count), i
        assert int(got.count) == int(want.count), i
        assert float(got.best_value) == float(want.best_value), i
        assert float(got.avg_value) == float(want.avg_value), i
        diff = max(float(np.abs(np.asarray(a) - t.detach().numpy()).max())
                   for a, t in zip(params, tparams))
        assert diff <= ATOL, (i, diff)
    assert min(scales) < 1.0, "the sequence never reached a plateau"


def test_plateau_scale_applies_to_the_update_that_closes_the_window():
    """The step whose value completes the patience-th flat window is
    already scaled down."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = Adam([p], 1.0, plateau=ReduceOnPlateau(patience=1, factor=0.5, device="cpu"))
    moves = []
    for value in (3.0, 3.0, 3.0):
        before = float(p.detach())
        p.grad = torch.ones(1)
        opt.step(torch.tensor(value))
        moves.append(before - float(p.detach()))
    # value 1 sets the best; value 2 is the first flat window = patience: halved at once
    np.testing.assert_allclose(moves, [1.0, 0.5, 0.25], rtol=1e-5)


def test_plateau_is_not_torchs_reduce_lr_on_plateau():
    """On one sequence torch's scheduler drops a window later (it waits
    until the count EXCEEDS patience) and ignores values during cooldown,
    where optax's `best` keeps updating."""
    ours = ReduceOnPlateau(patience=2, factor=0.5, cooldown=1, device="cpu")
    other = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    theirs = torch.optim.lr_scheduler.ReduceLROnPlateau(
        other, factor=0.5, patience=2, cooldown=1, threshold=1e-4)
    got, want = [], []
    for value in PLATEAU_VALUES[:10]:
        got.append(float(ours.update(torch.tensor(value))))
        theirs.step(float(value))
        want.append(other.param_groups[0]["lr"])
    assert got.index(0.5) + 1 == want.index(0.5), (got, want)


@pytest.mark.parametrize("kw", [dict(factor=1.0), dict(factor=0.0), dict(rtol=0.0, atol=0.0),
                                dict(rtol=-1.0), dict(rtol=2.0)])
def test_plateau_rejects_what_optax_rejects(kw):
    with pytest.raises(ValueError):
        optax.contrib.reduce_on_plateau(**kw)
    with pytest.raises(ValueError):
        ReduceOnPlateau(**kw, device="cpu")


def test_optimizer_state_round_trips():
    """state_dict carries the moments, the counts, the accumulated
    gradients, the schedule and the plateau state: a restored optimizer
    takes the same next steps."""
    p0, grads = _sequence()

    def make():
        params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        opt = Adam(params, 3e-3, every_k=2,
                   plateau=ReduceOnPlateau(patience=1, factor=0.5, device="cpu"))
        cosine_decay_schedule(opt, 8, 0.01)
        return params, opt

    def feed(params, opt, steps):
        for i in steps:
            for t, x in zip(params, grads[i]):
                t.grad = torch.from_numpy(x.copy())
            opt.step(torch.tensor(PLATEAU_VALUES[i]))

    a_params, a = make()
    feed(a_params, a, range(7))  # stops mid-accumulation
    b_params, b = make()
    with torch.no_grad():
        for t, s in zip(b_params, a_params):
            t.copy_(s)
    b.load_state_dict(copy.deepcopy(a.state_dict()))  # state_dict hands out references
    assert (b.count, b.mini_step) == (a.count, a.mini_step) == (3, 1)
    assert b.scheduler.last_epoch == a.scheduler.last_epoch == 3
    assert float(b.plateau.scale) == float(a.plateau.scale)
    feed(a_params, a, range(7, 12))
    feed(b_params, b, range(7, 12))
    for x, y in zip(a_params, b_params):
        assert torch.equal(x, y)


def test_a_parameter_without_a_gradient_counts_as_zero():
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    opt = Adam([a, b], 1e-2)
    a.grad = torch.ones(2)
    opt.step()
    assert torch.equal(b, torch.ones(2)) and not torch.equal(a, torch.ones(2))
