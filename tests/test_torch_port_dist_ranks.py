"""The rank side of tests/test_torch_port_dist.py (no test here): what one
process of a multi-process port run computes, importing only torch and the
port, so that the spawned ranks start without JAX. `run_rank` joins a gloo
group at a file store, runs the job's cases on its slice of each batch and
saves what it computed; `CASES` are also called in the test process with a
world of 1, which is the single-process port.

The Monte-Carlo samplers are replaced as tests/test_torch_port_training.py
replaces them (wi = normalize(n + 0.9 t(n)), t from the job's tables)."""

from __future__ import annotations

import os

import numpy as np
import torch

from nefii_tpu_torch.config import parse_string
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.models.loss import IDRLoss
from nefii_tpu_torch.ops import sampling as ts
from nefii_tpu_torch.parallel import dist, spmd
from nefii_tpu_torch.training.trainer import POOL_KEYS, distillation_loss, secondary_batch


SAMPLERS = ("cos_sampling", "brdf_sampling", "mix_sg_sampling_shared")


def training_batch(seed=0, S=16, R=2, W=64):
    """test_torch_port_training._batch: S pixels as 2x2 patches around
    centers on and off the sphere, R jittered rays each, a few pixels out of
    the object mask; -> (batch, gt) as numpy."""
    rs = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2] = K[1, 2] = W / 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -2.0]
    centers = np.array([[32, 32], [41, 27], [20, 44], [60, 4]], np.float64)
    du, dv = np.meshgrid(np.arange(-1, 1), np.arange(-1, 1))
    off = np.stack([du.reshape(-1), dv.reshape(-1)], -1)
    px = (centers[:, None, :] + off[None] + rs.uniform(-0.3, 0.3, (4, 1, 2))).reshape(S, 2)
    uv = (px[:, None, :] + rs.uniform(-0.5, 0.5, (S, R, 2)))[None].astype(np.float32)
    obj = np.ones((1, S), bool)
    obj[0, [2, 5, 13]] = False
    batch = {"intrinsics": K[None], "uv": uv, "pose": pose[None], "object_mask": obj}
    return batch, {"rgb": rs.uniform(0.0, 1.0, (1, S, 3)).astype(np.float32)}


def dir_tables():
    """test_torch_port_training._dir_tables: the injected directions' tables."""
    rs = np.random.RandomState(7)
    return [(rs.randn(3, 3) * 2.0).astype(np.float32) for _ in range(3)], \
        [rs.randn(3).astype(np.float32) for _ in range(3)]


def patch_samplers(tables):
    """Inject the deterministic directions into the port's sampling module.
    -> a function that puts the samplers back."""
    A, c = tables
    saved = {k: getattr(ts, k) for k in SAMPLERS}

    def wi_for(k, n):
        t = torch.sin(n @ torch.from_numpy(A[k]).to(n) + torch.from_numpy(c[k]).to(n))
        w = n + 0.9 * t / torch.linalg.norm(t, dim=-1, keepdim=True)
        return w / torch.linalg.norm(w, dim=-1, keepdim=True)

    ts.cos_sampling = lambda gen, n: (wi_for(0, n), ts.pdf_fn_cos(wi_for(0, n), n, None, None,
                                                                  None))
    ts.brdf_sampling = lambda gen, n, r, v: (
        wi_for(1, n), ts.pdf_fn_brdf_ggx(wi_for(1, n), n, v, r, None))
    ts.mix_sg_sampling_shared = lambda gen, n, lgt: (
        wi_for(2, n), ts.pdf_fn_mix_sg_shared(wi_for(2, n), n, None, None, lgt))
    return lambda: [setattr(ts, k, v) for k, v in saved.items()]


def _fresh(model, state):
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    return model


def _np(t):
    return t.detach().cpu().numpy().copy()


def _on(job, tensors):
    """numpy arrays -> tensors on the job's device."""
    return {k: torch.from_numpy(np.asarray(v)).to(job["device"]) for k, v in tensors.items()}


def _gen(job, seed):
    return torch.Generator(device=job["device"]).manual_seed(spmd.rank_seed(seed))


def _grads(model, extra=()):
    """Every parameter's gradient summed over the ranks (zeros for none)."""
    params = [p for p in model.parameters()] + list(extra)
    spmd.all_reduce_grads(params)
    return {n: (_np(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32))
            for n, p in model.named_parameters()}


def case_step(model, job, case):
    """One training step on this rank's slice of case["batch"]: the loss
    terms, every gradient (and the pose's with case["cameras"]), the pool
    gathered along the ray axis and the distilled batch selected from it."""
    _fresh(model, job["state"])
    batch = _on(job, spmd.shard_batch(case["batch"]))
    gt = _on(job, spmd.shard_batch(case["gt"]))
    pose = None
    if case.get("eik") is not None:
        batch["eik_override"] = _on(job, {"e": spmd.shard(case["eik"], name="eik")})["e"]
    if case.get("cameras"):
        pose = _on(job, {"p": case["pose_vec"]})["p"].requires_grad_(True)
        batch["pose"] = pose
    steps01 = case["steps01"][dist.rank()] if case["steps01"].ndim == 2 else case["steps01"]
    hook = spmd.loss_all_reduce()
    out = model.forward_with_uv(batch, _gen(job, 0), training=True,
                                freeze_geo=case["freeze_geo"],
                                steps01=_on(job, {"s": steps01})["s"],
                                secondary_limit=case["secondary_limit"], all_reduce=hook)
    ld = IDRLoss(**job["loss_conf"])(out, gt, alpha=job["loss_conf"]["alpha"], all_reduce=hook)
    ld["loss"].backward()
    res = {"terms": {k: float(v.detach()) for k, v in ld.items()},
           "grads": _grads(model, [pose] if pose is not None else [])}
    if pose is not None:
        res["pose_grad"] = _np(pose.grad)
    pool = {k: dist.gather_along(out[k], 1) for k in POOL_KEYS}
    res["pool"] = {k: _np(v) for k, v in pool.items()}
    picked = secondary_batch(pool, case["k_max"], case["num_rays"], dist.process_count())
    if picked is not None:
        pb, K, n_hit = picked
        res["distilled"] = {"K": K, "n_hit": n_hit, "rows": pb["points"].shape[0],
                            **{k: _np(v[:K]) for k, v in pb.items()}}
    return res


def case_distill(model, job, case):
    """The distillation step of case's K points ([K,R,3], K not a multiple of
    the world): padded to a multiple of the world, cut, L1 as (num, den)."""
    _fresh(model, job["state"])
    pb = _on(job, case["batch"])
    K, world = pb["points"].shape[0], dist.process_count()
    pool = {"secondary_points": pb["points"][None, :, 0],
            "secondary_dir": pb["ray_dirs"][None, :, 0],
            "secondary_mask": torch.ones(1, K, 1, dtype=torch.bool, device=job["device"])}
    pb, k, _ = secondary_batch(pool, K, pb["points"].shape[1], world)
    hook, valid = spmd.loss_all_reduce(), None
    if world > 1:
        valid = spmd.shard((torch.arange(pb["points"].shape[0], device=job["device"]) < k).float())
        pb = spmd.shard_batch(pb)
    loss = distillation_loss(model, pb, _gen(job, 0), valid=valid, all_reduce=hook)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads(model), "rows": pb["points"].shape[0]}


def case_eval(model, job, case):
    """The eval forward of case's batch sharded over the ranks."""
    _fresh(model, job["state"])
    out = spmd.eval_forward(model, _on(job, case["batch"]), _gen(job, 1), case["keys"])
    return {k: (_np(v) if torch.is_tensor(v) else v) for k, v in out.items()}


def case_step1(model, job, case):
    """Step 1: case["steps"] GeometryTrainRunner steps on the sampler's
    batches, each rank on its slice; the losses and the parameters."""
    from nefii_tpu_torch.training.geometry_trainer import GeometryTrainRunner
    from nefii_tpu_torch.utils import checkpoints as ckpt

    runner = GeometryTrainRunner(conf=parse_string(case["conf"]), mesh_path=case["mesh"],
                                 batch_points=case["batch_points"], max_niters=10,
                                 exps_folder_name=case["exps"] + f"/rank{dist.rank()}", seed=7,
                                 device="cpu")
    ckpt.params_from_jax(runner.model, case["params"])
    losses = []
    for i in range(case["steps"]):
        pts, sdf = runner.dataset[i]
        losses.append(float(runner.train_step(torch.as_tensor(spmd.shard(pts)),
                                              torch.as_tensor(spmd.shard(sdf)))))
    return {"losses": losses, "params": ckpt.params_to_jax(runner.model)}


CASES = {"step": case_step, "distill": case_distill, "eval": case_eval, "step1": case_step1}


def run_cases(job):
    """The job's cases in this process -> {name: result}."""
    restore = patch_samplers(job["tables"])
    try:
        model = IDRNetwork.from_conf(parse_string(job["model_conf"]).get_config("model"),
                                     device=job["device"])
        return {name: CASES[c["kind"]](model, job, c) for name, c in job["cases"].items()}
    finally:
        restore()


def run_rank(rank: int, world: int, store: str, job_path: str, out_dir: str) -> None:
    """One rank: join the gloo group (CUDA tensors too, on the job's device),
    run every case, save the results."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.initialize(num_processes=world, process_id=rank, device=job["device"], backend="gloo",
                    init_method=f"file://{store}")
    try:
        res = run_cases(job)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def start(target, args_of_rank, world: int):
    """Start `world` processes with `spawn` running target(*args_of_rank(r))."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout: float):
    """Join the processes within `timeout` seconds in all, kill what is left,
    and raise unless every one exited 0."""
    import time

    world = len(procs)
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks exited with {codes} (a negative code: killed at the "
                           f"{timeout:g} s limit or by a signal)")


def spawn(target, args_of_rank, world: int, timeout: float) -> None:
    join(start(target, args_of_rank, world), timeout)


def start_job(job, world: int, tmp: str):
    """Start the job's cases on `world` ranks; finish_job collects them."""
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    return tmp, start(run_rank, lambda r: (r, world, os.path.join(tmp, "store"), job_path, tmp),
                      world)


def finish_job(started, timeout: float = 240.0):
    """-> each rank's results of start_job's run."""
    tmp, procs = started
    join(procs, timeout)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]
