"""Fit a mixture of spherical Gaussians to an HDR environment map
(counterpart of nefii_tpu/scripts/fit_envmap_with_sg.py).

Adam on the image MSE of the SG mixture evaluated at every texel ([H*W, M, 3]
evaluations a step), a torch loop on --device, with the arithmetic of the
port's AdamGroup (optax.adam's, as the JAX package jits it) at a constant
learning rate. Writes `sg_<N>.npy`, which `--light_sg_path` /
`EnvmapMaterialNetwork.load_light` read, and the `log_im_<N>.png` preview.

    python -m nefii_tpu_torch.scripts.fit_envmap_with_sg --envmap env.exr \
        --num_sgs 128 --coordinate_type blender --n_iter 20000 [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def fit_envmap_sg(
    gt_envmap: np.ndarray,
    num_sgs: int = 128,
    coordinate_type: str = "mitsuba",
    n_iter: int = 100_000,
    lr: float = 1e-2,
    init: np.ndarray = None,
    log_every: int = 0,
    out_dir: str = None,
    seed: int = 0,
    device="cuda",
):
    """-> (lgtSGs [num_sgs, 7] after n_iter Adam steps, their loss). Without
    `init`, the lobes start as a normal draw of a torch.Generator seeded with
    `seed` on `device`, the sharpness column times 100."""
    from nefii_tpu_torch.ops.sg import envmap_view_dirs, extract_light_sg, sg_fn
    from nefii_tpu_torch.training.trainer import AdamGroup

    device = torch.device(device)
    H, W = gt_envmap.shape[:2]
    gt = torch.as_tensor(np.array(gt_envmap, np.float32), device=device)
    viewdirs = envmap_view_dirs(H, W, coordinate_type=coordinate_type, device=device)

    if init is not None:
        lgt = torch.as_tensor(np.asarray(init, np.float32), device=device).clone()
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        lgt = torch.randn((num_sgs, 7), generator=gen, device=device)
        lgt[:, 3:4] *= 100.0
    lgt = torch.nn.Parameter(lgt)

    def render(p):
        lobes, lambdas, mus = extract_light_sg(p)
        return sg_fn(viewdirs[..., None, :], lobes, lambdas, mus).sum(-2)  # [H,W,3]

    def loss_fn(p):
        return torch.mean((render(p) - gt) ** 2)

    opt = AdamGroup([lgt], lambda _: lr)
    for it in range(n_iter):
        opt.zero_grad()
        loss = loss_fn(lgt)
        loss.backward()
        opt.step()
        if log_every and it % log_every == 0:
            print(f"step {it}: loss {loss.item():.6f}")
            if out_dir:
                with torch.no_grad():
                    env = render(lgt).cpu().numpy()
                # a copy: on the CPU .numpy() shares the parameter's memory
                _save_progress(lgt.detach().cpu().numpy().copy(), env, gt_envmap, out_dir,
                               num_sgs)

    with torch.no_grad():
        final = float(loss_fn(lgt))
    return lgt.detach().cpu().numpy().copy(), final


def _save_progress(lgt, env, gt, out_dir, num_sgs):
    from nefii_tpu_torch.utils.png import write_png

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"sg_{num_sgs}.npy"), lgt)
    im = np.concatenate([gt, env], axis=0)
    im = np.clip(np.power(np.clip(im, 0, None), 1.0 / 2.2), 0, 1)
    write_png(os.path.join(out_dir, f"log_im_{num_sgs}.png"), (im * 255).astype(np.uint8))


def main(argv=None):
    from nefii_tpu_torch.utils import exr as exr_io
    from nefii_tpu_torch.utils.resize import resize

    p = argparse.ArgumentParser()
    p.add_argument("--envmap", required=True, help="HDR envmap (.exr)")
    p.add_argument("--num_sgs", type=int, default=128)
    p.add_argument("--coordinate_type", default="mitsuba", choices=["mitsuba", "blender"])
    p.add_argument("--n_iter", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--resize", type=int, nargs=2, default=[256, 512], metavar=("H", "W"))
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda raises if CUDA is absent)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")

    gt = exr_io.read(args.envmap)[:, :, :3]
    gt = resize(gt, (args.resize[0], args.resize[1]), "area")

    out_dir = args.out_dir or os.path.splitext(os.path.abspath(args.envmap))[0]
    os.makedirs(out_dir, exist_ok=True)

    init = None
    pretrained = os.path.join(out_dir, f"sg_{args.num_sgs}.npy")
    if os.path.isfile(pretrained):
        print("Loading:", pretrained)
        init = np.load(pretrained)

    lgt, loss = fit_envmap_sg(
        gt, args.num_sgs, args.coordinate_type, args.n_iter, args.lr,
        init=init, log_every=100, out_dir=out_dir, device=args.device,
    )
    _save_progress(lgt, gt * 0, gt, out_dir, args.num_sgs)
    print(f"final loss: {loss:.6f}; saved {pretrained}")


if __name__ == "__main__":
    main()
