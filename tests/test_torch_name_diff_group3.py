"""``tools/torch_name_diff.py`` over the modules of A.7 group 3 and
AlexNet: each JAX module's public names are all in its port
(``nn/layers_extra.py``, ``nn/layers_more.py``, ``nn/sparse.py``,
``nn/criterion_extra.py``, ``tensor/sparse.py``, ``models/alexnet.py``).
The tool parses both packages' sources and imports neither, so the test
runs it as a subprocess and asserts exit 0."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["nn/layers_extra.py", "nn/layers_more.py", "nn/sparse.py",
           "nn/criterion_extra.py", "tensor/sparse.py", "models/alexnet.py"]


def test_group3_names_are_all_ported():
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_name_diff.py"),
         *MODULES], capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.count("missing []") == len(MODULES), done.stdout
