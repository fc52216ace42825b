"""The tier-1 run's own rules (``torch_port_utils``, ``torch_port_train_full_width``):
an xdist worker's share of the cores, which the child processes it starts
inherit, and one FULL-width training case at a time."""

import os
import subprocess
import sys
import threading
import time

import torch_port_train_full_width as tw

HERE = os.path.dirname(os.path.abspath(__file__))

SCRIPT = r"""
import subprocess, sys
import torch_port_utils, torch
child = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                       capture_output=True, text=True, check=True, timeout=60)
print(torch.get_num_threads(), child.stdout.strip())
"""


def test_a_worker_and_its_children_take_the_workers_share_of_the_cores():
    env = dict(os.environ, PYTEST_XDIST_WORKER="gw1", PYTEST_XDIST_WORKER_COUNT="2",
               PYTHONPATH=os.path.dirname(HERE))
    env.pop("OMP_NUM_THREADS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=HERE, env=env, capture_output=True,
                         text=True, check=True, timeout=120)
    share = max(1, os.cpu_count() // 2)
    assert out.stdout.split()[-2:] == [str(share), str(share)]


def test_the_full_width_training_cases_run_one_at_a_time(tmp_path):
    lock = str(tmp_path / "cases.lock")
    guard, running, most = threading.Lock(), [0], [0]

    def case():
        with tw.one_case_at_a_time(lock):
            with guard:
                running[0] += 1
                most[0] = max(most[0], running[0])
            time.sleep(0.3)
            with guard:
                running[0] -= 1

    threads = [threading.Thread(target=case) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1
