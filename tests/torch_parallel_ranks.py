"""Bodies of the gloo ranks that tests/test_torch_parallel*.py start.

Each rank joins a CPU process group, runs the cases it is given on its
block of the samples (the port's collectives, and policy steps on a sample
mesh beside the same steps without one) and pickles what it got into
`out_dir/rank<r>.pkl` for the test to compare. It imports torch and the
port only: no jax, so that a rank starts in seconds.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from mpopis_tpu_torch.harness.simulate import simulate_car_racing
from mpopis_tpu_torch.models import CarRacingEnv, CheetahDeviceEnv, MountainCarEnv
from mpopis_tpu_torch.parallel import (
    distributed_init,
    gather_sample_costs,
    global_it_weights,
    global_mean_cov,
    global_top_k,
    global_weighted_mean_cov,
    make_sample_mesh,
)
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

TIMEOUT = datetime.timedelta(seconds=60)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _block(x, mesh, axis=0):
    start, stop = mesh.block(x.shape[axis])
    return torch.as_tensor(np.take(x, np.arange(start, stop), axis=axis))


def _unchanged(fn, *blocks):
    """fn(*blocks), and whether it left its inputs as they were."""
    before = [b.clone() for b in blocks]
    out = fn(*blocks)
    return out, all(torch.equal(a, b) for a, b in zip(before, blocks))


def _collectives(mesh, case):
    name, data = case["name"], case["data"]
    if name == "it_weights":
        w, ok = _unchanged(lambda c: global_it_weights(c, data["lam"], mesh),
                           _block(data["costs"], mesh))
        return {"w": _np(w), "inputs_kept": ok}
    if name == "weighted_mean_cov":
        (mu, cov), ok = _unchanged(lambda e, w: global_weighted_mean_cov(e, w, mesh),
                                   _block(data["e"], mesh, 1), _block(data["w"], mesh))
        return {"mu": _np(mu), "cov": _np(cov), "inputs_kept": ok}
    if name == "mean_cov":
        e = data["e"]
        (mu, cov), ok = _unchanged(lambda b: global_mean_cov(b, mesh, e.shape[1]),
                                   _block(e, mesh, 1))
        return {"mu": _np(mu), "cov": _np(cov), "inputs_kept": ok}
    if name == "top_k":
        (vals, idx), ok = _unchanged(lambda c: global_top_k(c, data["k"], mesh),
                                     _block(data["costs"], mesh))
        return {"vals": _np(vals), "idx": _np(idx), "inputs_kept": ok}
    if name == "gather":
        x = data["x"]
        out, ok = _unchanged(lambda b: gather_sample_costs(b, x.shape[0], mesh), _block(x, mesh))
        return {"x": _np(out), "inputs_kept": ok}
    raise ValueError(name)


def _env(task):
    if task == "car":
        return CarRacingEnv(dtype=torch.float64, device="cpu")
    if task == "mountaincar":
        return MountainCarEnv(dtype=torch.float64, device="cpu")
    return CheetahDeviceEnv(dtype=torch.float64, device="cpu")


def _steps(pol, env, n_steps, seed, z=None, uniforms=None):
    """`n_steps` closed-loop control steps from the reset: per step the
    action, the next U, the K costs and the iterations run (plus the logged
    trajectories where the policy logs them)."""
    s, ps, out = env.reset(), pol.init_state(seed), []
    for i in range(n_steps):
        kw = {}
        if z is not None:
            kw["z"] = torch.as_tensor(z[i])
        if uniforms is not None:
            kw["uniforms"] = torch.as_tensor(uniforms[i])
        a, ps, info = pol.step(s, ps, **kw)
        rec = {"action": _np(a), "U": _np(ps.U), "costs": _np(info["costs"]),
               "ais_its": info["ais_its"]}
        if "trajectories" in info:
            rec["trajectories"] = _np(info["trajectories"])
        out.append(rec)
        s = env.step(s, a)
    return out


def _policy(mesh, case):
    """The case's policy steps on the mesh and (`twin`) without one."""
    env = _env(case["task"])
    cfg = PolicyConfig(**case["cfg"])
    kw = dict(n_steps=case["steps"], seed=case.get("seed", 0), z=case.get("z"),
              uniforms=case.get("uniforms"))
    sharded = make_policy(env, cfg, cov_mat=case["cov"], sample_mesh=mesh)
    out = {"sharded": _steps(sharded, env, **kw)}
    if case.get("twin", True):
        out["twin"] = _steps(make_policy(env, cfg, cov_mat=case["cov"]), env, **kw)
    return out


def run_cases(rank, world_size, init_method, cases, out_dir):
    """One gloo rank: every case on the mesh of all ranks, pickled by name."""
    torch.set_num_threads(1)
    distributed_init("gloo", init_method=init_method, world_size=world_size, rank=rank,
                     timeout=TIMEOUT)
    distributed_init("gloo")  # a second call joins nothing
    try:
        mesh = make_sample_mesh(device="cpu")
        out = {"block": mesh.block(30), "mesh": (mesh.rank, mesh.world_size, str(mesh.device))}
        if not torch.cuda.is_available():
            try:
                make_sample_mesh()
                out["cuda default refused"] = False
            except RuntimeError:
                out["cuda default refused"] = True
        for case in cases:
            if "race" in case:  # the harness on the mesh, with no seed given
                m = simulate_car_racing(sample_mesh=mesh, seed=None, device="cpu",
                                        dtype=torch.float64, print_output=False, **case["race"])
                out[case["id"]] = {k: v for k, v in m.items()
                                   if k not in ("exec_times", "control_steps_per_s")}
                continue
            fn = _policy if "task" in case else _collectives
            out[case["id"]] = fn(mesh, case)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def fail_one_rank(rank, world_size, init_method):
    """Rank 0 waits in an all_reduce; rank 1 raises before joining it."""
    torch.set_num_threads(1)
    distributed_init("gloo", init_method=init_method, world_size=world_size, rank=rank,
                     timeout=TIMEOUT)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
