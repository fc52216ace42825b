"""The command line: python -m megaportraits_tpu_torch <command> [args]
(counterpart of ``megaportraits_tpu/__main__.py``).

Commands:
  train-base     stage-1 Gbase training        (train/main_base.py)
  train-hr       stage-2 Genh training         (train/main_hr.py)
  train-student  stage-3 Student distillation  (train/main_student.py)
  infer          single-pair inference         (infer/inference.py)
  reenact        drive a source image with a video (infer/video.py)
  eval           directory metric suite: not ported yet (ROADMAP Queue A item 4)

Each runs on the card unless given --device cpu.
"""

from __future__ import annotations

import sys


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    cmd = sys.argv[1]
    sys.argv = [f"megaportraits_tpu_torch {cmd}"] + sys.argv[2:]
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
    elif cmd == "eval":
        print("eval: eval/metrics.py is not ported yet (ROADMAP Queue A item 4)")
        return 1
    else:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 1
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
