"""K1 fp32 of two checkouts of this repository, side by side on one card.

    python nefii_tpu_torch/scripts/ab_k1_fp32.py run ROOT OUT_DIR TAG
    python nefii_tpu_torch/scripts/ab_k1_fp32.py compare OUT_DIR TAG_A TAG_B

`run` imports the package and chip_smoke.py of the checkout at ROOT (one
process a checkout: both name their package nefii_tpu_torch), builds its
kernels and, on the seeded inputs of chip_smoke's phases 3 and 12 (the
flagship 8x512 net, NeuS's 8x256 net on its 256 packing; 262,144 points of
generator seed 1, chip_smoke's camera rays):

  * saves K1 fp32's hidden state h, the fp32 sdf closure's values (the
    tracers' K1-fp32 queries) and K3's trace with its near re-trace into
    OUT_DIR/TAG-<net>.pt;
  * times the hidden entry and the sdf closure at 262,144 and 12,500 points
    (one near re-trace call's size), and K3 with and without its re-trace,
    into OUT_DIR/TAG.json, with the card's name and power limit.

`compare` says, for each saved tensor of two runs, whether it is equal bit
for bit, and the largest difference, and prints both runs' times. Run the
checkouts in turns (A, B, B, A) in one call to compare their times.
"""

from __future__ import annotations

import json
import os
import sys
import time

NEAR_POINTS = 12_500


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
    mconf = parse_string(cs._conf_text(name="conf_neus.conf")).get_config("model")
    nets = {"flagship": cs._flagship_net(dev),
            "neus": IDRNetwork.from_conf(mconf, device="cuda", seed=7).implicit_network}
    tracer = cs._conf_tracer()
    rays = cs._trace_rays(tracer, dev)["camera"]
    times = {"root": root, "card": card}
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        for name, net in nets.items():
            fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
            sdf_fn = fm.sdf_closure(fw)
            x = fm.embed_padded(pts, fw)
            fig = {"width": fw.width}
            for n, key in ((cs.N_POINTS, ""), (NEAR_POINTS, "near_")):
                reps = 5 if n == cs.N_POINTS else 20
                xn, pn = x[:n].contiguous(), pts[:n].contiguous()
                fig[key + "hidden_ms"] = cs._time(lambda: fm.fused_hidden(xn, fw), reps)
                fig[key + "sdf_closure_ms"] = cs._time(lambda: sdf_fn(pn), reps)
            stats = {}
            trace = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
            fig["k3_ms"] = cs._time(lambda: ft.fused_sphere_trace(*rays, fw, tracer), 3)
            fig["k3_kernel_alone_ms"] = cs._time(lambda: ft._trace_kernel(*rays, fw, tracer), 3)
            fig["near_rays"] = stats["n_near"]
            fig["retrace_evals"] = stats["retrace_evals"]
            torch.save({"h": fm.fused_hidden(x, fw).cpu(), "sdf": sdf_fn(pts).cpu(),
                        "k3": [t.cpu() for t in trace[:3]]},
                       os.path.join(out_dir, f"{tag}-{name}.pt"))
            times[name] = fig
            print(f"[ab {tag}] {name} at width {fw.width}: {fig} [{card}]", flush=True)
    times["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(times, f)


def compare(out_dir: str, a: str, b: str) -> None:
    import torch

    for name in ("flagship", "neus"):
        ta, tb = (torch.load(os.path.join(out_dir, f"{t}-{name}.pt")) for t in (a, b))
        for key in ("h", "sdf", "k3"):
            xs, ys = ta[key], tb[key]
            xs, ys = (xs, ys) if isinstance(xs, list) else ([xs], [ys])
            same = all(torch.equal(x, y) for x, y in zip(xs, ys))
            diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(xs, ys))
            print(f"[ab] {name} {key}: {a} and {b} equal bit for bit: {same} (largest "
                  f"difference {diff:.3e})", flush=True)
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
