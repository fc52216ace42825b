"""The port imports nothing of JAX, flax, optax, orbax or the JAX package.

A fresh interpreter blocks ``jax``, ``flax``, ``optax`` and ``orbax`` (an
import of any raises), and ``PIL``, ``cv2`` and ``yaml``, which the machine
with the card lacks (the port reads YAML and images without them, and
imports cv2 only inside the functions that decode or write video files),
and ``matplotlib`` and ``scipy``, which the port imports
only inside the functions that draw or compute with them, and the tests'
helpers (``torch_port_utils``, ``torch_port_full_width``); it imports every
module of ``megaportraits_tpu_torch`` and lists the modules of the JAX
package that got loaded: there must be none.
Every module imports on a host without a card (the kernels are built and
``triton``/``nvcc`` reached only when a kernel is launched).
"""

import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = r"""
import importlib, json, pkgutil, sys
for blocked in ("jax", "flax", "optax", "orbax", "PIL", "cv2", "yaml", "matplotlib",
                "scipy", "tests", "torch_port_utils", "torch_port_full_width"):
    sys.modules[blocked] = None
import megaportraits_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "megaportraits_tpu" or m.startswith("megaportraits_tpu."))
print(json.dumps({"imported": names, "jax_package": loaded}))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["jax_package"] == []
    for name in ("megaportraits_tpu_torch.__main__",
                 "megaportraits_tpu_torch.data.dataset",
                 "megaportraits_tpu_torch.data.prefetch",
                 "megaportraits_tpu_torch.data.segmentation",
                 "megaportraits_tpu_torch.eval.heldout",
                 "megaportraits_tpu_torch.train.main_base",
                 "megaportraits_tpu_torch.train.main_hr",
                 "megaportraits_tpu_torch.train.main_student",
                 "megaportraits_tpu_torch.utils.logging",
                 "megaportraits_tpu_torch.train.train_base",
                 "megaportraits_tpu_torch.train.train_hr",
                 "megaportraits_tpu_torch.train.train_student",
                 "megaportraits_tpu_torch.core.checkpoint",
                 "megaportraits_tpu_torch.infer.inference",
                 "megaportraits_tpu_torch.infer.video",
                 "megaportraits_tpu_torch.utils.image",
                 "megaportraits_tpu_torch.utils.pretrained",
                 "megaportraits_tpu_torch.losses.perceptual",
                 "megaportraits_tpu_torch.models.discriminator",
                 "megaportraits_tpu_torch.core.config",
                 "megaportraits_tpu_torch.core.yaml_subset",
                 "megaportraits_tpu_torch.utils.jpeg",
                 "megaportraits_tpu_torch.ops.warp",
                 "megaportraits_tpu_torch.ops.resize",
                 "megaportraits_tpu_torch.models.fan",
                 "megaportraits_tpu_torch.data.landmarks",
                 "megaportraits_tpu_torch.losses.gaze",
                 "megaportraits_tpu_torch.losses.vggface",
                 "megaportraits_tpu_torch.losses.perceptual_multi",
                 "megaportraits_tpu_torch.losses.rome",
                 "megaportraits_tpu_torch.utils.convert_weights",
                 "megaportraits_tpu_torch.eval.metrics",
                 "megaportraits_tpu_torch.parallel.mesh",
                 "megaportraits_tpu_torch.parallel.sharding_rules",
                 "megaportraits_tpu_torch.core.debug",
                 "megaportraits_tpu_torch.utils.profiling",
                 "megaportraits_tpu_torch.utils.viz",
                 "megaportraits_tpu_torch.models.encoders",
                 "megaportraits_tpu_torch.models.cifar_resnet",
                 "megaportraits_tpu_torch.models.repvgg",
                 "megaportraits_tpu_torch.models.resnet",
                 "megaportraits_tpu_torch.ops.warp_alt",
                 "megaportraits_tpu_torch.data.pose_datasets",
                 "megaportraits_tpu_torch.scripts.check_device",
                 "megaportraits_tpu_torch.scripts.train_smoke",
                 "megaportraits_tpu_torch.scripts.overfit",
                 "megaportraits_tpu_torch.scripts.validate_student",
                 "megaportraits_tpu_torch.utils.seeded"):
        assert name in result["imported"]
