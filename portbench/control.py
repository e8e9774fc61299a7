"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6]

For each seed, the forward error a run of the cell compares (the image its
checked sweep infers on, and the worst over the first ``--images`` of the
seed's stream): the program's forward against the float64 reference (the
lower readings), and, for each control seed, the control's: the
reference's own forward on TF32-rounded operands, put in the program's
place (the upper readings). The rows downstream of the forward are
compared exactly, with the limit 0, so only the forward needs readings.
Prints one JSON object a seed and a summary last.
"""
import argparse
import json
import os
import random
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
    import torch
    from harness import cells, images
    from reference.forward import forward_error, forward_traffic, \
        load_weights
    from repro_torch.models import trained_model

    cell = cells.find_cell(cells.load_spec(ROOT), ROOT, args.workload)
    cfg = cell.config
    dev = torch.device(args.device)
    tm = trained_model(cfg["model"], args.device)
    weights = load_weights(ROOT, cfg["weights"])
    hw, _, ch = cfg["input_shape"]
    n_check = int(cell.traffic["check"]["sweeps"])
    pool = int(cell.traffic["images"]["pool"])

    def readings(seed: int, control: bool) -> dict:
        imgs = images.glyph_images(seed, pool + 1, hw, ch, dev)
        checked = 1 + random.Random(seed).randrange(n_check)
        errs = {}
        for i in sorted({checked, *range(1, 1 + args.images)}):
            ref = forward_traffic(cfg, weights, imgs[i], "float64")
            got = (forward_traffic(cfg, weights, imgs[i], "tf32") if control
                   else [(t.inputs, t.weights) for t in
                         tm.model.layer_traffic(imgs[i])])
            errs[i] = forward_error(got, ref)
        return {"seed": seed, "side": "control" if control else "program",
                "checked_image": checked, "checked": errs[checked],
                "worst": max(errs.values())}

    out = []
    for s in filter(None, args.seeds.split(",")):
        out.append(readings(int(s), False))
        print(json.dumps(out[-1]), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        out.append(readings(int(s), True))
        print(json.dumps(out[-1]), flush=True)
    prog = [r["worst"] for r in out if r["side"] == "program"]
    ctl = [r["checked"] for r in out if r["side"] == "control"]
    print(json.dumps({"workload": args.workload,
                      "lower": max(prog) if prog else None,
                      "upper": min(ctl) if ctl else None,
                      "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
