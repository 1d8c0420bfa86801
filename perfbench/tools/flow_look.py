"""Where the flow cells' gaps to the reference come from: the program and
the float32 reference, each against the same reference in float64, on the
same seeds.

    python3 perfbench/tools/flow_look.py --seeds 1,2,3 [--test-seeds 4,5] \
        [--measure-seeds 6,7] [--out look.jsonl]

from the root of a checkout, on the card (``--cpu-tiny``: at the tests'
tiny sizes on the CPU). For each ``--seeds`` seed of ``flow-rbf-train-b3``
it runs the cell's set-up with its checked steps, then the reference in
float32, in float32 with every batch's pairs in reverse order (another
order of the same sums), and in float64, and prints for each two of them
the numbers of the check (``harness/compare.py``) with the worst leaf's
name. It then takes the first step apart at the flows: the loss's gradient
by each pixel's flow in float32 and in float64, the share of their gap that
the pixels with the largest gaps hold, and the first gradient's worst leaf
gap with the float32 flow gradients carried back through the float64 net,
as they are and with those pixels' taken from float64. For each
``--test-seeds`` seed of ``flow-rbf-test-b8`` it compares the program's
flows of one pass with the reference's in float32 and in float64. For each
``--measure-seeds`` seed it compares the first gradients and steps of the
program, the control and the half batch with the float32 reference's, and
float32's with float64's, by other measures than the check's
(:func:`gradient_measures`).
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import core  # noqa: E402
from harness.compare import moving_leaves, training_numbers  # noqa: E402
from reference import flow  # noqa: E402
from reference.precision import strict_fp32  # noqa: E402

TOPS = (16, 64, 256, 1024)


def worst_leaf(a, b, keep=None):
    names = list(b) if keep is None else list(keep)
    an = {k: float(torch.linalg.norm(a[k].double())) for k in names}
    bn = {k: float(torch.linalg.norm(b[k].double())) for k in names}
    med = statistics.median(bn.values())
    gaps = {k: abs(an[k] - bn[k]) / max(bn[k], med, 1e-30) for k in names}
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def reference(e, dtype, reverse=False):
    from entries.flow_train import make_clip
    video, _ = make_clip(e.config, e.traffic, e.seed, e.device)
    video = video.to(dtype)
    batches = [flow.pair_batch(video, pairs[::-1] if reverse else pairs)
               for pairs in e.checked]
    p0 = {k: v.to(dtype) for k, v in e.p0.items()}
    with strict_fp32():
        out = flow.train_steps(p0, e.config, batches)
    return out, batches


def compare(p0, a, b):
    nums = dict(training_numbers(p0, a, b))
    keep = moving_leaves(b[1])
    ch = lambda p, q: {k: (p[k].double() - q[k].double()) for k in keep}
    nums["grad_leaf"] = worst_leaf(a[1], b[1])[0]
    nums["change_leaf"] = worst_leaf(ch(a[3], p0), ch(b[3], p0))[0]
    return nums


def gradient_measures(p0, a, b):
    """Ways to compare two first gradients (and first steps) beside the
    worst leaf's gap of norms: the quartiles of the first layer's rows'
    gaps of norms (a row per encoding centre), each leaf's gap of norms, the
    whole
    gradient's relative difference, one minus its cosine, the share of its
    elements whose sign differs, and the first step's relative
    difference."""
    ga, gb = a[1], b[1]
    keys = list(gb)
    flat = lambda g: torch.cat([g[k].double().flatten() for k in keys])
    va, vb = flat(ga), flat(gb)
    d1a = torch.cat([(a[2][k].double() - p0[k].double()).flatten()
                     for k in keys])
    d1b = torch.cat([(b[2][k].double() - p0[k].double()).flatten()
                     for k in keys])
    bn = {k: float(torch.linalg.norm(gb[k].double())) for k in keys}
    med = statistics.median(bn.values())
    ra = torch.linalg.norm(ga["mlp0.w"].double(), dim=1)
    rb = torch.linalg.norm(gb["mlp0.w"].double(), dim=1)
    row_gaps = (ra - rb).abs() / torch.clamp(rb, min=float(rb.median()))
    return {
        "first_layer_row_gaps": [float(torch.quantile(row_gaps, q))
                                 for q in (0.5, 0.75, 0.9)],
        "leaf_gaps": {k: abs(float(torch.linalg.norm(ga[k].double())) - bn[k])
                      / max(bn[k], med) for k in keys},
        "grad_diff": float(torch.linalg.norm(va - vb) / torch.linalg.norm(vb)),
        "grad_1_minus_cos": float(1 - torch.dot(va, vb) / (
            torch.linalg.norm(va) * torch.linalg.norm(vb) + 1e-300)),
        "grad_sign_share": float((torch.sign(va) != torch.sign(vb)).double()
                                 .mean()),
        "change1_diff": float(torch.linalg.norm(d1a - d1b)
                              / torch.linalg.norm(d1b)),
    }


def look_measures(cell, seed, cpu):
    """:func:`gradient_measures` of the program, the float32 reference
    with TF32 operands (the control) and over half of each batch, each
    against the float32 reference, and of float32 against float64."""
    from harness import controls
    device = "cpu" if cpu else "cuda"
    e, _ = controls.program_numbers(copy.deepcopy(cell), seed, 0.0, device,
                                    check=False)
    r32 = e.reference()
    keep = controls.batch_rows(cell)
    rows = {"program": (e.losses, e.g1, e.p1, e.p3),
            "control": e.reference("tf32"),
            "half_batch": e.reference(keep=keep - keep // 2)}
    out = {k: gradient_measures(e.p0, v, r32) for k, v in rows.items()}
    out["ref32_vs_ref64"] = gradient_measures(e.p0, r32,
                                              reference(e, torch.float64)[0])
    return {"seed": seed, **out}


def pixel_look(e, batch32, batch64):
    """The first step at the flows (the first batch, the weights p0)."""
    out = {}
    grads, leaf_graphs = {}, {}
    for name, b in (("fp32", batch32), ("fp64", batch64)):
        dt = b["frame1"].dtype
        p = {k: v.detach().to(dt).requires_grad_(
            k.startswith("mlp") and name == "fp64") for k, v in e.p0.items()}
        h, w = b["frame1"].shape[1:3]
        with strict_fp32():
            f12, f21 = flow.query(p, b["times"], h, w, float(b["scale"]))
            l12 = f12.detach().requires_grad_(True)
            l21 = f21.detach().requires_grad_(True)
            loss = flow.photometric(e.config, b["frame1"], b["frame2"],
                                    l12, l21)
            g12, g21 = torch.autograd.grad(loss, [l12, l21])
        grads[name] = (g12, g21)
        leaf_graphs[name] = (p, f12, f21)
    g32 = torch.cat([g.double() for g in grads["fp32"]], dim=0)
    g64 = torch.cat(grads["fp64"], dim=0)
    d = torch.linalg.norm(g32 - g64, dim=-1).flatten()
    mag = torch.linalg.norm(g64, dim=-1).flatten()
    tot = float((d * d).sum())
    order = torch.argsort(d, descending=True)
    out["flow_grad_gap"] = float(torch.sqrt(d.pow(2).sum()
                                            / mag.pow(2).sum()))
    out["top_share"] = {k: float((d[order[:k]] ** 2).sum()) / tot
                        for k in TOPS}
    out["top_mag_over_median"] = float(mag[order[0]] / mag.median())
    b = batch64
    n, h, w = b["frame1"].shape[:3]
    ys = torch.arange(h, device=g64.device, dtype=torch.float64)
    xs = torch.arange(w, device=g64.device, dtype=torch.float64)
    flows = torch.cat([f.detach() for f in leaf_graphs["fp64"][1:]], dim=0)
    rows = []
    for flat in order[:8].tolist():
        s, rem = divmod(flat, h * w)
        y, x = divmod(rem, w)
        fx, fy = flows[s, y, x].tolist()
        tx, ty = float(xs[x]) + fx, float(ys[y]) + fy
        rows.append({"pair_dir": s, "y": y, "x": x, "flow": [fx, fy],
                     "target_frac": [tx - int(tx // 1), ty - int(ty // 1)],
                     "gap": float(d[flat]), "mag64": float(mag[flat])})
    out["top_pixels"] = rows
    # the leaf gradient from the float32 flow gradients, carried back
    # through the float64 net: as they are, and with the top pixels' taken
    # from float64
    p, f12, f21 = leaf_graphs["fp64"]
    leaves = [k for k in p if k.startswith("mlp")]
    g_ref = dict(zip(leaves, torch.autograd.grad(
        [f12, f21], [p[k] for k in leaves], grads["fp64"],
        retain_graph=True)))
    for k_top in (0,) + TOPS:
        gg = g32.clone().reshape(-1, 2)
        if k_top:
            idx = order[:k_top]
            gg[idx] = g64.reshape(-1, 2)[idx]
        gg = gg.reshape(g64.shape)
        g_mix = dict(zip(leaves, torch.autograd.grad(
            [f12, f21], [p[k] for k in leaves], [gg[:n], gg[n:]],
            retain_graph=True)))
        out[f"grad_gap_fp32_flows_top{k_top}_from_fp64"] = worst_leaf(
            g_mix, g_ref)
    return out


def look_train(cell, seed, cpu):
    from harness import controls
    device = "cpu" if cpu else "cuda"
    e, _ = controls.program_numbers(copy.deepcopy(cell), seed, 0.0, device,
                                    check=False)
    prog = (e.losses, e.g1, e.p1, e.p3)
    r32, b32 = reference(e, torch.float32)
    r32r, _ = reference(e, torch.float32, reverse=True)
    r64, b64 = reference(e, torch.float64)
    row = {"seed": seed,
           "prog_vs_ref32": compare(e.p0, prog, r32),
           "prog_vs_ref64": compare(e.p0, prog, r64),
           "ref32_vs_ref64": compare(e.p0, r32, r64),
           "ref32rev_vs_ref32": compare(e.p0, r32r, r32)}
    row["pixels"] = pixel_look(e, b32[0], b64[0])
    return row


def look_test(cell, seed, cpu):
    from harness import controls
    device = "cpu" if cpu else "cuda"
    e, nums = controls.program_numbers(copy.deepcopy(cell), seed, 1.0, device)
    named = e.named
    out = {"seed": seed, "prog_vs_ref32": nums}
    refs = {}
    for dt in (torch.float32, torch.float64):
        e.named = {k: v.to(dt) for k, v in named.items()}
        refs[dt] = e.reference()
    e.named = named
    last = [(i, e.last["flow12"][i], e.last["masks"][i])
            for i in range(e.last["flow12"].shape[0])]
    f64, m64 = refs[torch.float64]
    m64 = [m.float() for m in m64]
    out["prog_vs_ref64"] = dict(e.numbers(f64, m64, last))
    s32 = [(i, f.cpu().numpy(), m.cpu().numpy())
           for i, (f, m) in enumerate(zip(*refs[torch.float32]))]
    out["ref32_vs_ref64"] = dict(e.numbers(f64, m64, s32))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="")
    ap.add_argument("--test-seeds", default="")
    ap.add_argument("--measure-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args()
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cell_of(name):
        if args.cpu_tiny:
            from harness.tiny import tiny_cell
            return tiny_cell(name)
        return core.resolve(bench, name, root)

    def emit(row):
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for s in seeds(args.seeds):
        t0 = time.perf_counter()
        row = look_train(cell_of("flow-rbf-train-b3"), s, args.cpu_tiny)
        row["seconds"] = time.perf_counter() - t0
        emit(dict(row, workload="flow-rbf-train-b3"))
    for s in seeds(args.measure_seeds):
        t0 = time.perf_counter()
        row = look_measures(cell_of("flow-rbf-train-b3"), s, args.cpu_tiny)
        row["seconds"] = time.perf_counter() - t0
        emit(dict(row, workload="flow-rbf-train-b3"))
    for s in seeds(args.test_seeds):
        t0 = time.perf_counter()
        row = look_test(cell_of("flow-rbf-test-b8"), s, args.cpu_tiny)
        row["seconds"] = time.perf_counter() - t0
        emit(dict(row, workload="flow-rbf-test-b8"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
