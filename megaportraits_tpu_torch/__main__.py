"""The command line: python -m megaportraits_tpu_torch <command> [args]
(counterpart of ``megaportraits_tpu/__main__.py``).

Commands:
  train-base     stage-1 Gbase training        (train/main_base.py)
  train-hr       stage-2 Genh training         (train/main_hr.py)
  train-student  stage-3 Student distillation  (train/main_student.py)
  infer          single-pair inference         (infer/inference.py)
  reenact        drive a source image with a video (infer/video.py)
  eval           directory metric suite        (eval/metrics.py)

Each runs on the card unless given --device cpu.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def run_eval(argv: Optional[Sequence[str]] = None) -> int:
    """``eval --output-dir A --target-dir B [--pretrained P] [--device D]``:
    prints the metric dict of the PNG pairs."""
    import argparse

    from megaportraits_tpu_torch.eval.metrics import evaluate_metrics, make_eval_callables

    parser = argparse.ArgumentParser(prog="megaportraits_tpu_torch eval")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--target-dir", required=True)
    parser.add_argument(
        "--pretrained", default="",
        help="converted-weight bundle (utils/convert_weights.py); enables real "
             "LPIPS, 68-point FAN landmarks for AKD, and vggface identity "
             "embeddings for AED")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    lpips_apply = embedding_apply = None
    if args.pretrained:
        lpips_apply, embedding_apply = make_eval_callables(args.pretrained, args.device)
        if lpips_apply is not None:
            print("eval: converted LPIPS active")
        if embedding_apply is not None:
            print("eval: vggface identity embeddings active (AED)")
    print(evaluate_metrics(args.output_dir, args.target_dir, lpips_apply=lpips_apply,
                           embedding_apply=embedding_apply,
                           pretrained_path=args.pretrained or "./pretrained",
                           device=args.device))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the command of `argv` (``sys.argv[1:]`` by default)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "eval":
        return run_eval(argv[1:])
    sys.argv = [f"megaportraits_tpu_torch {cmd}"] + argv[1:]
    if cmd == "train-base":
        from megaportraits_tpu_torch.train.main_base import main as run
    elif cmd == "train-hr":
        from megaportraits_tpu_torch.train.main_hr import main as run
    elif cmd == "train-student":
        from megaportraits_tpu_torch.train.main_student import main as run
    elif cmd == "infer":
        from megaportraits_tpu_torch.infer.inference import main as run
    elif cmd == "reenact":
        from megaportraits_tpu_torch.infer.video import main as run
    else:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 1
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
