"""Count-evaluation CLI: score-JSON dir → per-video CSV + MAE/OBO +
per-action meta CSV.

The port's own copy of ``workoutdetector_tpu/scripts/eval_count.py``, a
front end over ``counting.eval_score_dir`` / ``analyze_count`` (pandas,
imported inside them).

    python -m workoutdetector_tpu_torch.scripts.eval_count SCORES/ anno.csv \
        [-o eval.csv]
"""

from __future__ import annotations

import argparse

from workoutdetector_tpu_torch.counting import analyze_count, eval_score_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate rep-count scores")
    parser.add_argument("json_dir", help="directory of *.score.json files")
    parser.add_argument("anno", help="RepCount annotation.csv")
    parser.add_argument("-o", "--out-csv", default=None)
    parser.add_argument("--softmax", action="store_true")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--step", type=int, default=8)
    args = parser.parse_args(argv)

    mae, obo, rows = eval_score_dir(args.json_dir, args.anno, args.out_csv,
                                    softmax=args.softmax,
                                    threshold=args.threshold, step=args.step)
    print(f"=====Mean absolute error: {mae:.4f}, OBO acc: {obo:.4f}=====")
    if args.out_csv:
        meta = analyze_count(args.out_csv, args.out_csv.replace(".csv", "_meta.csv"))
        print(meta.to_string())


if __name__ == "__main__":
    main()
