"""One sharded training step and one sharded distillation step on n gloo
ranks on the CPU at tiny shapes (counterpart of __graft_entry__.py's
dryrun_multichip): the multi-process path end to end without a card.

    python -m nefii_tpu_torch.scripts.dryrun_multichip --n 2

Each rank is a process started with `spawn`; the group meets at a file in a
temporary directory. A rank builds __graft_entry__'s small flagship model
(3x64 nets, 8 SG lobes) from seed 0, takes its slice of a 4n-pixel batch,
and runs the trainer's step: the forward with the secondary-hit pool (its
hit counts summed over the ranks), IDRLoss through the all-reduce hook, the
gradients summed, both Adam groups; then the pools gathered along the ray
axis, 2n hits selected, padded to a multiple of n, cut over the ranks and
distilled. It checks finite losses and parameters equal on every rank, and
rank 0 prints the losses.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

SMALL_CONF = """
model {
    render_type = pt_render_indirect_mlp
    use_fused_sdf = False
    fused_sdf_dtype = float32
    feature_vector_size = 64
    render_background = True
    implicit_network {
        d_in = 3
        d_out = 1
        dims = [64, 64, 64]
        geometric_init = True
        bias = 0.6
        skip_in = [1]
        weight_norm = True
        multires = 6
        use_last_as_f = True
    }
    envmap_material_network {
        multires = 10
        dims = [64, 64, 64]
        white_specular = True
        num_lgt_sgs = 8
        num_base_materials = 1
        fix_specular_albedo = True
        specular_albedo = [0.5, 0.5, 0.5]
        roughness_mlp = True
        specular_mlp = True
        same_mlp = True
    }
    rendering_network {
        mode = idr
        d_in = 9
        d_out = 3
        dims = [64, 64]
        weight_norm = True
        multires_view = 4
        multires_xyz = 10
        normalize_output = False
        clip_output = True
        clip_method = pow2
        weight_init = True
    }
    ray_tracer {
        object_bounding_sphere = 1.0
        sdf_threshold = 5.0e-5
        line_search_step = 0.5
        line_step_iters = 1
        sphere_tracing_iters = 4
        n_steps = 16
        n_rootfind_steps = 4
    }
}
"""
LOSS = dict(idr_rgb_weight=1.0, sg_rgb_weight=1.0, eikonal_weight=0.1, mask_weight=100.0,
            alpha=50.0, loss_type="L1", env_loss_type="L2", background_rgb_weight=1.0)


def _batch(S: int, W: int = 64):
    """__graft_entry__._example_batch: S pixels of a W x W view of the sphere."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = W * 1.2
    K[0, 2] = K[1, 2] = W / 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -2.5]
    uv = np.random.RandomState(0).uniform(W * 0.3, W * 0.7, (1, S, 2)).astype(np.float32)
    gt = {"rgb": np.random.RandomState(1).rand(1, S, 3).astype(np.float32)}
    return {"uv": uv, "object_mask": np.ones((1, S), bool), "intrinsics": K[None],
            "pose": pose[None]}, gt


def _rank(rank: int, n: int, store: str) -> None:
    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.models.loss import IDRLoss
    from nefii_tpu_torch.parallel import dist, spmd
    from nefii_tpu_torch.training.trainer import (
        POOL_KEYS, AdamGroup, distillation_loss, multistep_lr, secondary_batch,
        trainable_names)

    torch.set_num_threads(1)
    dist.initialize(num_processes=n, process_id=rank, device="cpu",
                    init_method=f"file://{store}")
    try:
        model = IDRNetwork.from_conf(parse_string(SMALL_CONF).get_config("model"), seed=0)
        names = trainable_names(model)
        params = dict(model.named_parameters())
        groups = [AdamGroup([params[k] for k in names[g]], multistep_lr(5e-4, [], 1.0))
                  for g in ("idr", "sg")]
        S = 4 * n
        batch, gt = _batch(S)
        batch = {k: torch.from_numpy(v) for k, v in spmd.shard_batch(batch).items()}
        gt = {k: torch.from_numpy(v) for k, v in spmd.shard_batch(gt).items()}
        gen = torch.Generator().manual_seed(spmd.rank_seed(2))
        hook = spmd.loss_all_reduce()

        out = model.forward_with_uv(batch, gen, training=True, secondary_limit=3 * S * n,
                                    all_reduce=hook)
        loss = IDRLoss(**LOSS)(out, gt, all_reduce=hook)["loss"]
        loss.backward()
        for g in groups:
            spmd.all_reduce_grads(g.params)
            g.step()
            g.zero_grad()

        pool = {k: dist.gather_along(out[k], 1) for k in POOL_KEYS}
        picked = secondary_batch(pool, 2 * n, 4, n)
        if picked is None:
            raise RuntimeError("dryrun_multichip: the step found no secondary hit")
        pbatch, k, _ = picked
        valid = spmd.shard((torch.arange(pbatch["points"].shape[0]) < k).float())
        l_sec = distillation_loss(model, spmd.shard_batch(pbatch), gen, valid=valid,
                                  all_reduce=hook)
        l_sec.backward()
        for g in groups:
            spmd.all_reduce_grads(g.params)
            g.step()

        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        ref = flat.clone()
        torch.distributed.broadcast(ref, 0)
        lv, ls = float(loss.detach()), float(l_sec.detach())
        if not (np.isfinite(lv) and np.isfinite(ls)):
            raise RuntimeError(f"dryrun_multichip: non-finite loss {lv}, {ls}")
        if not torch.equal(flat, ref):
            raise RuntimeError(f"dryrun_multichip: rank {rank}'s parameters differ from rank 0's")
        if rank == 0:
            print(f"dryrun_multichip({n}): OK, loss={lv:.6f} secondary_loss={ls:.6f}",
                  flush=True)
    finally:
        dist.shutdown()


def dryrun_multichip(n: int, timeout: float = 300.0) -> None:
    """Run the n ranks as spawned processes; raises if one fails or any
    outlives `timeout` seconds (then all are killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, n, os.path.join(d, "store")))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dryrun_multichip({n}): rank exit codes {codes}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=2, help="gloo ranks on the CPU")
    dryrun_multichip(parser.parse_args(argv).n)


if __name__ == "__main__":
    main()
