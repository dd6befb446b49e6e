"""Times of the rotated kernels of one checkout of the PyTorch port, for A/B
runs on one card, on the inputs the rotated Faster R-CNN gave them:

* R1 (``ops/roi_align_rotated.py::pairwise_iou_rotated``,
  ``ops/csrc/iou_rotated.cu``) on a train step's RRPN matching (the gt
  slots against the broadcast anchors) and on its proposal sampling;
* R2 (``ops/roi_align_rotated.py::nms_rotated``, ``ops/csrc/nms.cu``'s
  pipeline for rotated boxes) on the RRPN's rows at test and at training
  and on the box head's class-aware rows, on the rows ``chip_smoke.py``
  23e holds to the plain loop and on all of them; for each, the stage
  table of one call (``stage_table``): the device time of every kernel
  of the pipeline, the bitmask tiles and the scans panel by panel.

Each kernel is held to its plain version first (R1 within 1e-5 where the
second box has an area, R2 index for index but for rows whose first
difference is a tie within 1e-5 of the threshold). CUDA events over
repeated calls after warm-up; the stage tables from ``torch.profiler``.

The inputs come from ``chip_smoke.py --rotated-cases FILE`` (23e's
captured inputs, saved with ``torch.save``). The checkout measured is the
one on PYTHONPATH, whatever checkout this file comes from: to compare two,
unpack one with ``git archive`` into a directory git ignores and run them
in turns in one call (a, b, b, a)::

    for t in output/parent . . output/parent; do
        PYTHONPATH=$t python3 detectron2_centernet_tpu_torch/tools/rotated_ab.py \\
            --cases output/rotated_cases.pt --json output/rotated_ab.jsonl; done

Each run prints one line per case and a stage table per R2 case and, with
``--json``, appends one JSON object to the file.
"""
import argparse
import json
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import detectron2_centernet_tpu_torch as pkg
from detectron2_centernet_tpu_torch.ops import cuda_lib
from detectron2_centernet_tpu_torch.ops import roi_align_rotated as rot
from detectron2_centernet_tpu_torch.tools import bench

# the kernels of ops/csrc/nms.cu and ops/csrc/iou_rotated.cu, as the profiler names them
STAGES = ("nms_init", "nms_hist", "nms_choose", "nms_compact", "nms_sort", "nms_mask", "nms_scan", "nms_next",
          "iou_rotated")
PLAIN_ROWS = {"rpn_test_rotated": 1, "rpn_train_rotated": 1, "box_head_rotated": None}
TOL = 1e-5
cuda_ms = bench.Clock("cuda").ms  # mean ms per call, CUDA events


def stage_label(name: str, seen: dict) -> str:
    """The stage a kernel of the NMS pipeline belongs to, in launch order:
    ``nms_init`` starts a call's first round and ``nms_next`` the next one
    (``seen`` counts them; " r2" marks the second round's kernels), the
    n-th ``nms_mask`` / ``nms_scan`` after a round's ``nms_sort`` is panel
    n's."""
    stage = next((s for s in STAGES if s in name), "other")
    if stage == "nms_init":
        seen.clear()
    elif stage == "nms_sort":
        seen["mask"] = seen["scan"] = 0
    label = stage
    if stage in ("nms_mask", "nms_scan"):
        panel = seen.get(stage[4:], 0)
        seen[stage[4:]] = panel + 1
        label = f"{stage} p{panel}"
    round_ = seen.get("round", 1)
    if stage == "nms_next":
        seen["round"] = round_ + 1
    return label + (f" r{round_}" if round_ > 1 and stage != "other" else "")


def stage_table(fn, calls: int = 3) -> dict:
    """{stage: (device µs per call, launches per call)} of ``fn`` (one call
    of a pipeline) under the profiler, ``calls`` calls after one warm-up,
    in launch order; "total" sums them. Kernels the card launches itself
    (later rounds) appear only where the profiler records them. The window
    opens on a few spinning kernels, which are left out with every kernel
    of another name: the profiler has been seen to drop the first kernels
    of its window, and, after other profiling in the process, all of a
    window's kernels, which a second window then records (up to three are
    tried)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(100_000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)), key=lambda e: e.time_range.start)
        seen = {}
        labelled = [(stage_label(e.name, seen), e) for e in kernels]
        labelled = [(label, e) for label, e in labelled if label != "other"]
        if labelled:
            break
    us, count, order = defaultdict(float), defaultdict(int), []
    for label, e in labelled:
        if label not in us:
            order.append(label)
        us[label] += e.time_range.elapsed_us()
        count[label] += 1
    table = {k: (us[k] / calls, count[k] / calls) for k in order}
    table["total"] = (sum(us.values()) / calls, sum(count.values()) / calls)
    return table


def format_table(table: dict) -> str:
    return "; ".join(f"{k} {us:.1f} µs" + (f" ×{n:g}" if n != 1 else "") for k, (us, n) in table.items())


def iou_case(a, b):
    """R1 on (a, b) against its plain clip: (max |kernel - plain| where the
    second box has an area, kernel ms)."""
    got = rot.pairwise_iou_rotated(a, b)
    want = rot.pairwise_iou_rotated_plain(a, b)
    keep = (b[..., 2] * b[..., 3] > 0).unsqueeze(-2).expand_as(got)
    err = (got - want).abs()[keep].max().item()
    return err, cuda_ms(lambda: rot.pairwise_iou_rotated(a, b), iters=20)


def nms_case(name, boxes, scores, classes, thr, counts):
    """R2 on a case against the plain loop on its first rows (``PLAIN_ROWS``):
    {equal, ties, ms (those rows), ms_all_rows, stages, stages_all_rows}."""
    rows = PLAIN_ROWS.get(name)
    sub = slice(None) if rows is None else slice(0, rows)
    bx, sc = boxes[sub].contiguous(), scores[sub].contiguous()
    cl = None if classes is None else classes[sub].contiguous()
    cn = counts if isinstance(counts, int) else counts[sub]
    got = rot.nms_rotated(bx, sc, thr, cn, cl)
    want = rot.nms_rotated_fixed(bx, sc, thr, cn, cl)
    ties = rot.nms_pick_ties(bx, sc, thr, got, want, cl, eps=TOL)
    equal = ties["differing_rows"] == 0 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = lambda: rot.nms_rotated(bx, sc, thr, cn, cl)  # noqa: E731
    every = lambda: rot.nms_rotated(boxes, scores, thr, counts, classes)  # noqa: E731
    return dict(rows=sc.shape[0], all_rows=scores.shape[0], candidates=sc.shape[1], equal=equal, ties=ties,
                ms=cuda_ms(one, iters=10), ms_all_rows=cuda_ms(every, iters=5), stages=stage_table(one),
                stages_all_rows=stage_table(every))


def ptxas_report(built: dict) -> list:
    """The lines of nvcc's ``-Xptxas -v`` report (registers, stack, spills)
    of the rotated kernels' sources."""
    lines = []
    for name in ("nms", "iou_rotated"):
        log = built[name]["log"].splitlines()
        for i, line in enumerate(log):
            if "Compiling entry" in line and "otated" in line:  # RotatedBoxes, nms_mask_rotated, iou_rotated
                lines += [s.strip() for s in log[i:i + 4] if "Compiling" in s or "registers" in s or "spill" in s]
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cases", required=True, help="the file chip_smoke.py --rotated-cases wrote")
    parser.add_argument("--json", help="append this run's numbers to this JSON-lines file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rotated_ab.py needs a CUDA card")
    card = bench.card()
    tree = pkg.__file__.split("/detectron2_centernet_tpu_torch")[0]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    built = cuda_lib.build_libraries()
    ptxas = ptxas_report(built)
    for line in ptxas:
        print(f"{tree}: ptxas: {line}", flush=True)
    saved = torch.load(args.cases)
    to = lambda t: None if t is None else t.cuda()  # noqa: E731
    result = dict(tree=tree, card=card, ptxas=ptxas, iou={}, nms={})
    for name, (a, b) in saved["iou"].items():
        err, ms = iou_case(to(a), to(b))
        result["iou"][name] = dict(shape=[list(a.shape), list(b.shape)], max_abs_err=err, ms=ms)
        print(f"{tree}: R1 {name} {tuple(a.shape)} x {tuple(b.shape)}: max |kernel - plain| {err:.2e} (tol {TOL:g}); "
              f"{ms:.4f} ms", flush=True)
        if not err <= TOL:
            raise SystemExit(f"R1 disagrees with its plain version on {name}: {err}")
    for name, (boxes, scores, classes, thr, counts) in saved["nms"].items():
        r = nms_case(name, to(boxes), to(scores), to(classes), thr, counts)
        result["nms"][name] = r
        print(f"{tree}: R2 {name}: {r['rows']} of {r['all_rows']} rows x {r['candidates']}: "
              f"{'equal' if r['equal'] else 'DIFFERENT'} to the plain loop ({r['ties']['ties']} tie rows, "
              f"{r['ties']['not_ties']} other); {r['ms']:.4f} ms, all rows {r['ms_all_rows']:.4f} ms", flush=True)
        print(f"{tree}:   stages ({r['rows']} rows): {format_table(r['stages'])}", flush=True)
        print(f"{tree}:   stages (all rows): {format_table(r['stages_all_rows'])}", flush=True)
        if r["ties"]["not_ties"] or r["ties"]["ties"] > 0.001 * r["ties"]["picks"]:
            raise SystemExit(f"R2 disagrees with the plain loop on {name}: {r['ties']}")
    print(f"{tree}: {card}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
