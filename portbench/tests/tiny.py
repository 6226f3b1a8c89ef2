"""Sizes for rehearsing a cell on the CPU: the cell's conf and traffic at
widths of 64 and a few hundred rays (the kernels' plain versions run there).

At width 64 the fitted SDF is rougher than the 512-wide net's, and the
port's and the reference's fp32 traces part on about a percent of the rays
(the 99th-percentile point gap ~0.007, secondary flips 1-2% over seeds 1-3
on the CPU, against 0.002 and 0.5% for the full-size cells on the card),
so the rehearsal holds the three trace numbers to the limits below; every
other number keeps the cell's own. A fault still reads far above them
(K1's value shifted by 0.02: flips ~5%, point gap ~0.07)."""

W = 64
TINY = {
    "conf": {"model.feature_vector_size": W, "model.implicit_network.dims": [W] * 8,
             "model.rendering_network.dims": [W] * 4,
             "model.envmap_material_network.dims": [W] * 8,
             "model.envmap_material_network.num_lgt_sgs": 8,
             "train.num_pixels": 64, "train.num_rays": 4},
    "params": {"n_views": 4, "res": 32, "secondary_batch_size": 8, "fit_steps": 600,
               "fit_batch": 2048, "num_rays": 4, "memory_capacity_level": 10,
               "check_chunks": [0, 1, 2], "trace_chunks": 2},
    "limits": {"trace_flip_share": 0.01, "trace_point_gap": 0.03, "sec_flip_share": 0.05},
}


def tiny_run(cell_name, seed=2 ** 31 + 7, seconds=0.3, trace=False):
    import time

    from portbench import core

    cell = core.cell(cell_name)
    cell.limits = {**cell.limits, **{k: v for k, v in TINY["limits"].items()
                                     if k in cell.limits}}
    return core.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                    tiny=TINY, t0=time.perf_counter())
