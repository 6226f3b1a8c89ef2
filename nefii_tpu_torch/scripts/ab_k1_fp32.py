"""K1 of two checkouts of this repository, side by side on one card.

    python nefii_tpu_torch/scripts/ab_k1_fp32.py run ROOT OUT_DIR TAG
    python nefii_tpu_torch/scripts/ab_k1_fp32.py compare OUT_DIR TAG_A TAG_B

`run` imports the package, chip_smoke.py and portbench/ of the checkout at
ROOT (one process a checkout: both name their package nefii_tpu_torch),
builds its kernels and, on four nets: the flagship 8x512 net and NeuS's 8x256
net of chip_smoke's phases 3 and 12 (262,144 points of generator seed 1,
chip_smoke's camera rays), and both nets fitted to the benchmark's scene as
portbench's runs fit them (`fitted-nefii`, `fitted-neus`; 262,144 points
uniform in the scene's ball of radius 1.5), each on the packings the
closures use (the 8x256 at 256):

  * saves K1 fp32's hidden state h, the fp32 and the bf16 sdf closures'
    values (the tracers' K1 queries) and K3's trace with its near re-trace
    into OUT_DIR/TAG-<net>.pt;
  * times the hidden entry, the sdf entry alone and the sdf closure (the
    entry and, in checkouts whose entry takes the embedded points, the
    positional encoding in PyTorch) in fp32 and bf16 at 262,144 and 12,500
    points (one near re-trace call's size), and K3 with and without its
    re-trace, into OUT_DIR/TAG.json, with the card's name and power limit.

`compare` says, for each saved tensor of two runs, whether it is equal bit
for bit, how many rows differ, and the largest difference, and prints both
runs' times. Run the checkouts in turns (A, B, B, A) in one call to compare
their times.
"""

from __future__ import annotations

import json
import os
import sys
import time

NEAR_POINTS = 12_500
NETS = ("flagship", "neus", "fitted-nefii", "fitted-neus")
FITTED_CONFS = {"fitted-nefii": "confs/conf.conf", "fitted-neus": "confs/conf_neus.conf"}


def _fitted_net(root: str, conf_path: str, dev):
    """The SDF net of `conf_path` fitted to the benchmark's scene, as
    portbench's set-up fits it (FIT_SEED; its workloads' 500 steps of 16,384
    points)."""
    from nefii_tpu_torch.config import ConfigFactory
    from nefii_tpu_torch.models.idr import IDRNetwork
    from portbench import harness

    conf = ConfigFactory.parse_file(os.path.join(root, conf_path))
    P, _ = harness.make_weights(conf.get_config("model").as_plain_dict(), 0,
                                {"fit_steps": 500, "fit_batch": 16_384}, dev)
    model = IDRNetwork.from_conf(conf.get_config("model"), device=dev)
    harness.load_into(model, P)
    return model.implicit_network


def _entry_input(fm, fw, pts):
    """What the checkout's sdf entry takes: the points, or (before the entry
    encoded them) their embedding."""
    try:
        fm.fused_sdf_value(pts[:1], fw)
        return pts
    except ValueError:
        return fm.embed_padded(pts, fw)


def run(root: str, out_dir: str, tag: str) -> None:
    root, out_dir = os.path.abspath(root), os.path.abspath(out_dir)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.ops.kernels import fused_mlp as fm
    from nefii_tpu_torch.ops.kernels import fused_trace as ft

    t0 = time.perf_counter()
    card = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    dev = torch.device("cuda", 0)
    pts = torch.randn(cs.N_POINTS, 3, generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev) * 0.5
    g = torch.Generator(device=dev).manual_seed(2)
    ball = torch.randn(cs.N_POINTS, 3, generator=g, device=dev)
    ball = ball / ball.norm(dim=1, keepdim=True) * 1.5 * torch.rand(
        cs.N_POINTS, 1, generator=g, device=dev) ** (1 / 3)
    mconf = parse_string(cs._conf_text(name="conf_neus.conf")).get_config("model")
    nets = {"flagship": (cs._flagship_net(dev), pts),
            "neus": (IDRNetwork.from_conf(mconf, device="cuda", seed=7).implicit_network, pts)}
    nets.update({name: (_fitted_net(root, path, dev), ball) for name, path in FITTED_CONFS.items()})
    tracer = cs._conf_tracer()
    rays = cs._trace_rays(tracer, dev)["camera"]
    times = {"root": root, "card": card}
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        for name, (net, p) in nets.items():
            fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
            f16 = fm.network_weights(net, torch.bfloat16, fm.TC_WIDTHS)
            sdf_fn, sdf16_fn = fm.sdf_closure(fw), fm.sdf_closure(f16)
            x = fm.embed_padded(p, fw)
            fig = {"width": fw.width}
            for n, key in ((cs.N_POINTS, ""), (NEAR_POINTS, "near_")):
                reps = 5 if n == cs.N_POINTS else 20
                xn, pn = x[:n].contiguous(), p[:n].contiguous()
                e32, e16 = _entry_input(fm, fw, pn), _entry_input(fm, f16, pn)
                fig[key + "hidden_ms"] = cs._time(lambda: fm.fused_hidden(xn, fw), reps)
                fig[key + "sdf_entry_ms"] = cs._time(lambda: fm.fused_sdf_value(e32, fw), reps)
                fig[key + "sdf_closure_ms"] = cs._time(lambda: sdf_fn(pn), reps)
                fig[key + "sdf_entry_bf16_ms"] = cs._time(lambda: fm.fused_sdf_value(e16, f16),
                                                          reps)
                fig[key + "sdf_closure_bf16_ms"] = cs._time(lambda: sdf16_fn(pn), reps)
            stats = {}
            trace = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
            fig["k3_ms"] = cs._time(lambda: ft.fused_sphere_trace(*rays, fw, tracer), 3)
            fig["k3_kernel_alone_ms"] = cs._time(lambda: ft._trace_kernel(*rays, fw, tracer), 3)
            fig["near_rays"] = stats["n_near"]
            fig["retrace_evals"] = stats["retrace_evals"]
            torch.save({"h": fm.fused_hidden(x, fw).cpu(), "sdf": sdf_fn(p).cpu(),
                        "sdf_bf16": sdf16_fn(p).cpu(), "k3": [t.cpu() for t in trace[:3]]},
                       os.path.join(out_dir, f"{tag}-{name}.pt"))
            times[name] = fig
            print(f"[ab {tag}] {name} at width {fw.width}: {fig} [{card}]", flush=True)
    times["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(times, f)


def compare(out_dir: str, a: str, b: str) -> None:
    import torch

    for name in NETS:
        ta, tb = (torch.load(os.path.join(out_dir, f"{t}-{name}.pt")) for t in (a, b))
        for key in ("h", "sdf", "sdf_bf16", "k3"):
            xs, ys = ta[key], tb[key]
            xs, ys = (xs, ys) if isinstance(xs, list) else ([xs], [ys])
            same = all(torch.equal(x, y) for x, y in zip(xs, ys))
            rows = sum(int((x != y).reshape(x.shape[0], -1).any(1).sum()) for x, y in zip(xs, ys))
            diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(xs, ys))
            print(f"[ab] {name} {key}: {a} and {b} equal bit for bit: {same} ({rows} of "
                  f"{xs[0].shape[0]} rows differ, largest difference {diff:.3e})", flush=True)
    for t in (a, b):
        with open(os.path.join(out_dir, f"{t}.json")) as f:
            print(f"[ab] {t}: {json.load(f)}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"] and len(sys.argv) == 5:
        run(*sys.argv[2:])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 5:
        compare(*sys.argv[2:])
    else:
        sys.exit(__doc__)
