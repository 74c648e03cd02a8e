"""Bundle adjustment with the observation table sharded over a list of
devices.

Port of ``multicol_slam_tpu/parallel/ba_sharding.py``. The reference is
single-node shared-memory (SURVEY.md section 2.3); its scale axis is the
map size of global BA. Observations are data-parallel: each shard
linearizes its rows into partial normal-equation blocks on its own
device, the partial blocks are summed in shard order and the ``E`` rows
gathered on ``devices[0]``, the small reduced camera system is solved
there once, and the new poses and points are copied to every shard's
device for the next linearization.

The JAX package runs one program over a ``Mesh`` through ``shard_map``,
with ``psum`` and ``all_gather`` over the mesh axis, and solves the
reduced system replicated on every device. Here one process drives an
explicit list of ``torch.device``s: the two collectives are a sum and a
concatenation onto ``devices[0]`` (``reduce_sum``, ``gather_rows``), and
one solve plus a copy replaces the replicated solve, with the same
outputs. A list may name one device several times (the CPU in the tests,
one card) or several cards, where the copies are device-to-device.

Entry points:
  make_sharded_ba_step -- one damped Schur step (building block, tests);
  make_sharded_ba      -- the full LM, the accept / reject and lambda
                          schedule of ``optimizer.bundle_adjustment``, so
                          ``global_ba.run_global_ba`` can route here when
                          its mesh has more than one device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models import optimizer as opt
from ..models.optimizer import BAObservations
from ..ops.rig import Rig
from ..utils import graphs


def mesh_devices(devices: Sequence) -> list[torch.device]:
    """The list as ``torch.device``s, a card without an index as the
    current one; raises when it is empty or mixes device types."""
    devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh of one device type only, got {devs}")
    return devs


def pad_obs_to_multiple(obs: BAObservations, n_shards: int) -> BAObservations:
    """Pad the observation table so that ``n_shards`` divides its rows:
    pad rows are invalid, with keyframe, camera and point 0, so a
    ``pt_obs`` table keeps pointing at the original pad row."""
    k = obs.uv.shape[0]
    pad = -(-k // n_shards) * n_shards - k
    if pad == 0:
        return obs
    return BAObservations(*(
        torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                  device=t.device)]) for t in obs))


def shard_obs(obs: BAObservations, devices: Sequence) -> list[BAObservations]:
    """Contiguous row blocks of a padded table, block i on ``devices[i]``
    (the block order of ``shard_map`` over ``P(OBS_AXIS)``)."""
    devs = mesh_devices(devices)
    k = obs.uv.shape[0]
    if k % len(devs):
        raise ValueError(f"{k} observation rows do not split into {len(devs)} shards: "
                         "pad them with pad_obs_to_multiple")
    ks = k // len(devs)
    return [BAObservations(*(t[i * ks:(i + 1) * ks].to(d) for t in obs))
            for i, d in enumerate(devs)]


def reduce_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of per-shard tensors in shard order, on ``device`` (the
    counterpart of ``psum``)."""
    return _in_shard_order([t.to(device) for t in parts])


def _in_shard_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for t in parts[1:]:
        out = out + t
    return out


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Per-shard rows concatenated in shard order on ``device`` (the
    counterpart of ``all_gather(tiled=True)``)."""
    return torch.cat([t.to(device) for t in parts])


def shard_linearize(rig: Rig, obs: BAObservations, fixed_kf: torch.Tensor,
                    fixed_pt: torch.Tensor, mt: torch.Tensor, X: torch.Tensor,
                    n_kf: int, n_pt: int, huber: float):
    """One shard's linearization at (mt, X), on its device: the blocks of
    ``optimizer.make_ba_blocks`` (Hpp, gp, Hxx, gx, E) and the shard's
    robust cost at that point. The unit graphed on each shard's device."""
    blocks, _ = opt.make_ba_blocks(rig, obs, fixed_kf, fixed_pt, n_kf, n_pt, huber)
    return blocks(mt, X)


def sharded_lm_step(parts, mt_c: torch.Tensor, X_c: torch.Tensor, point, lm,
                    kf: torch.Tensor, valid: torch.Tensor, pt_obs: torch.Tensor,
                    fixed_kf: torch.Tensor, fixed_pt: torch.Tensor, n_kf: int,
                    solve: bool):
    """The root's part of one LM iteration, on ``devices[0]``: the shards'
    ``parts`` (each ``shard_linearize``'s outputs at the candidate (mt_c,
    X_c), already on this device) summed in shard order and their ``E``
    rows gathered; then ``optimizer.lm_accept`` of the candidate against
    the LM state ``lm`` = (cost, lam, done) at the current ``point`` =
    (mt, X, blocks), or, with ``point`` None, the candidate taken as the
    start (``lm``'s cost None); with ``solve``, the damped Schur step
    (``optimizer.make_schur_solve`` over the whole table's ``kf``,
    ``valid`` and ``pt_obs``) from the point kept. Returns a dict: the
    ``point`` and ``lm`` kept and, with ``solve``, the ``next`` candidate.
    A rejected candidate leaves the point's blocks, which its own
    linearization made, so each point is linearized once. The unit graphed
    on ``devices[0]``."""
    cost_c = _in_shard_order([p[5] for p in parts])
    blocks_c = tuple(_in_shard_order([p[i] for p in parts]) for i in range(4)) + (
        torch.cat([p[4] for p in parts]),)
    cost, lam, done = lm
    if point is None:
        mt, X, blocks, cost = mt_c, X_c, blocks_c, cost_c
    else:
        take, cost, lam, done = opt.lm_accept(cost, cost_c, lam, done)
        mt = torch.where(take, mt_c, point[0])
        X = torch.where(take, X_c, point[1])
        blocks = tuple(torch.where(take, b_c, b) for b_c, b in zip(blocks_c, point[2]))
    out = dict(point=(mt, X, blocks), lm=(cost, lam, done))
    if solve:
        dp, dx = opt.make_schur_solve(kf, valid, pt_obs, fixed_kf, fixed_pt, n_kf)(
            *blocks, lam)
        # r = m - pi, so the step is minus the solve
        out["next"] = (mt - dp, X - dx)
    return out


def sharded_units(devices: Sequence[torch.device], pool):
    """(shard_linearize, sharded_lm_step) for a mesh: on cards the pool's
    CUDA graphs of them (``graphs.SHARED`` if ``pool`` is None), one
    wrapper per pool and function, so a later BA of the same keys replays;
    elsewhere the plain functions. A graph is captured on one device, so
    the copies between devices stay outside them."""
    if not graphs.graphed(devices[0]):
        return shard_linearize, sharded_lm_step
    pool = pool or graphs.SHARED
    return pool.jit(shard_linearize), pool.jit(sharded_lm_step)


def _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf, fixed_pt, n_kf, n_pt,
                     huber, units):
    """``run(mt, X, point, lm, solve)`` of one sharded problem: every
    shard linearizes at the candidate (mt, X) (the copies to and from its
    device outside the units), then the root's ``sharded_lm_step``; every
    tensor in and out on ``devices[0]``."""
    if len(obs_shards) != len(devs):
        raise ValueError(f"{len(obs_shards)} observation shards for {len(devs)} devices")
    for d, o in zip(devs, obs_shards):
        if o.uv.device != d:
            raise ValueError(f"a shard lies on {o.uv.device}, its device is {d}")
    root = devs[0]
    linearize, lm_step = units
    fixed = {d: (fixed_kf.to(d), fixed_pt.to(d)) for d in dict.fromkeys(devs)}
    tables = (gather_rows([o.kf for o in obs_shards], root),
              gather_rows([o.valid for o in obs_shards], root), pt_obs.to(root),
              fixed_kf.to(root), fixed_pt.to(root))

    def run(mt, X, point, lm, solve):
        reps = {d: (mt.to(d), X.to(d)) for d in dict.fromkeys(devs)}
        parts = [tuple(t.to(root) for t in linearize(rigs[d], o, *fixed[d], *reps[d],
                                                     n_kf, n_pt, huber))
                 for d, o in zip(devs, obs_shards)]
        return lm_step(parts, mt, X, point, lm, *tables, n_kf, solve)

    return run


def make_sharded_ba_step(devices: Sequence, rig: Rig, n_kf: int, n_pt: int,
                         huber: float = opt.HUBER_GLOBAL, pool=None):
    """One damped Schur step with the observations sharded over
    ``devices``:
        step(mt_min (N, 6), X (P, 3), obs_shards (from shard_obs), pt_obs
             (P, M), fixed_kf (N,), fixed_pt (P,), lam)
          -> (mt_min', X', robust cost at the input), on devices[0].
    On cards each shard's linearization and the root's reduction and solve
    are CUDA graphs of ``pool`` (``sharded_units``); ``lam`` becomes a
    device tensor before them."""
    devs = mesh_devices(devices)
    rigs = {d: rig.to(d) for d in dict.fromkeys(devs)}
    units = sharded_units(devs, pool)

    def step(mt, X, obs_shards, pt_obs, fixed_kf, fixed_pt, lam):
        run = _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf, fixed_pt,
                               n_kf, n_pt, huber, units)
        root = devs[0]
        lam = torch.as_tensor(lam, dtype=X.dtype, device=root)
        done = torch.zeros((), dtype=torch.bool, device=root)
        out = run(mt.to(root), X.to(root), None, (None, lam, done), True)
        return out["next"] + (out["lm"][0],)

    return step


def make_sharded_ba(devices: Sequence, rig: Rig, n_kf: int, n_pt: int, *,
                    iters: int = 10, huber: float = opt.HUBER_GLOBAL, pool=None):
    """The full sharded LM bundle adjustment: ``iters`` masked steps of
    ``optimizer.bundle_adjustment``'s schedule (``optimizer.lm_accept``:
    lambda from 1e-4 in the problem's dtype, halved on accept, quadrupled
    on reject, frozen after an accepted step whose gain is under 1e-6),
    so the device never waits for the host, with every point's
    linearization data-parallel over ``devices``: the shards linearize
    each candidate once, and its blocks serve the next step when it is
    taken. On cards each shard's linearization and the root's reduction,
    accept / reject and solve are CUDA graphs of ``pool``
    (``sharded_units``), the LM state a device tensor between them:
        ba(mt_min (N, 6), X (P, 3), obs_shards, pt_obs, fixed_kf, fixed_pt)
          -> (mt_min', X', final robust cost), on devices[0]."""
    devs = mesh_devices(devices)
    rigs = {d: rig.to(d) for d in dict.fromkeys(devs)}
    root = devs[0]
    units = sharded_units(devs, pool)

    def ba(mt0, X0, obs_shards, pt_obs, fixed_kf, fixed_pt):
        run = _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf, fixed_pt,
                               n_kf, n_pt, huber, units)
        mt, X = mt0.to(root), X0.to(root)
        lam = torch.full((), 1e-4, dtype=X.dtype, device=root)
        done = torch.zeros((), dtype=torch.bool, device=root)
        point, lm = None, (None, lam, done)
        for i in range(iters + 1):
            out = run(mt, X, point, lm, i < iters)
            point, lm = out["point"], out["lm"]
            if i < iters:
                mt, X = out["next"]
        return point[0], point[1], lm[0]

    return ba
