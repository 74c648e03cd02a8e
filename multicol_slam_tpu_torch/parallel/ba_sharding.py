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
    out = parts[0].to(device)
    for t in parts[1:]:
        out = out + t.to(device)
    return out


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Per-shard rows concatenated in shard order on ``device`` (the
    counterpart of ``all_gather(tiled=True)``)."""
    return torch.cat([t.to(device) for t in parts])


def _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf, fixed_pt, n_kf, n_pt,
                     huber):
    """(cost_of, step) of one sharded problem: ``cost_of(mt, X)`` the
    robust cost summed over the shards, ``step(mt, X, lam)`` one damped
    Schur step -> (mt', X', robust cost at the input); every tensor in
    and out on ``devices[0]``."""
    if len(obs_shards) != len(devs):
        raise ValueError(f"{len(obs_shards)} observation shards for {len(devs)} devices")
    root = devs[0]
    shards = []
    for d, o in zip(devs, obs_shards):
        if o.uv.device != d:
            raise ValueError(f"a shard lies on {o.uv.device}, its device is {d}")
        shards.append(opt.make_ba_blocks(rigs[d], o, fixed_kf.to(d), fixed_pt.to(d),
                                         n_kf, n_pt, huber))
    solve = opt.make_schur_solve(
        gather_rows([o.kf for o in obs_shards], root),
        gather_rows([o.valid for o in obs_shards], root), pt_obs.to(root),
        fixed_kf.to(root), fixed_pt.to(root), n_kf)

    def replicas(t):
        return {d: t.to(d) for d in dict.fromkeys(devs)}

    def cost_of(mt, X):
        mts, Xs = replicas(mt), replicas(X)
        return reduce_sum([cost(mts[d], Xs[d])[0] for d, (_, cost) in zip(devs, shards)],
                          root)

    def step(mt, X, lam):
        mts, Xs = replicas(mt), replicas(X)
        parts = [blocks(mts[d], Xs[d]) for d, (blocks, _) in zip(devs, shards)]
        Hpp, gp, Hxx, gx = (reduce_sum([p[i] for p in parts], root) for i in range(4))
        E = gather_rows([p[4] for p in parts], root)
        cost = reduce_sum([p[5] for p in parts], root)
        dp, dx = solve(Hpp, gp, Hxx, gx, E, lam)
        # r = m - pi, so the step is minus the solve
        return mt - dp, X - dx, cost

    return cost_of, step


def make_sharded_ba_step(devices: Sequence, rig: Rig, n_kf: int, n_pt: int,
                         huber: float = opt.HUBER_GLOBAL):
    """One damped Schur step with the observations sharded over
    ``devices``:
        step(mt_min (N, 6), X (P, 3), obs_shards (from shard_obs), pt_obs
             (P, M), fixed_kf (N,), fixed_pt (P,), lam)
          -> (mt_min', X', robust cost at the input), on devices[0]."""
    devs = mesh_devices(devices)
    rigs = {d: rig.to(d) for d in dict.fromkeys(devs)}

    def step(mt, X, obs_shards, pt_obs, fixed_kf, fixed_pt, lam):
        _, one = _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf, fixed_pt,
                                  n_kf, n_pt, huber)
        root = devs[0]
        return one(mt.to(root), X.to(root), torch.as_tensor(lam, dtype=X.dtype, device=root))

    return step


def make_sharded_ba(devices: Sequence, rig: Rig, n_kf: int, n_pt: int, *,
                    iters: int = 10, huber: float = opt.HUBER_GLOBAL):
    """The full sharded LM bundle adjustment: ``iters`` masked steps of
    ``optimizer.bundle_adjustment``'s schedule (``optimizer.lm_accept``:
    lambda from 1e-4 in the problem's dtype, halved on accept, quadrupled
    on reject, frozen after an accepted step whose gain is under 1e-6),
    so the device never waits for the host, with every step's
    linearization data-parallel over ``devices``:
        ba(mt_min (N, 6), X (P, 3), obs_shards, pt_obs, fixed_kf, fixed_pt)
          -> (mt_min', X', final robust cost), on devices[0]."""
    devs = mesh_devices(devices)
    rigs = {d: rig.to(d) for d in dict.fromkeys(devs)}
    root = devs[0]

    def ba(mt0, X0, obs_shards, pt_obs, fixed_kf, fixed_pt):
        cost_of, step = _sharded_problem(devs, rigs, obs_shards, pt_obs, fixed_kf,
                                         fixed_pt, n_kf, n_pt, huber)
        mt, X = mt0.to(root), X0.to(root)
        cost = cost_of(mt, X)
        lam = torch.full((), 1e-4, dtype=X.dtype, device=root)
        done = torch.zeros((), dtype=torch.bool, device=root)
        for _ in range(iters):
            mt_new, X_new, _ = step(mt, X, lam)
            take, cost, lam, done = opt.lm_accept(cost, cost_of(mt_new, X_new), lam, done)
            mt = torch.where(take, mt_new, mt)
            X = torch.where(take, X_new, X)
        return mt, X, cost

    return ba
