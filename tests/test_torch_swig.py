"""The port's SWIG JVM interface (``lightgbm_tpu_torch/swig/``).

The JNI library needs a JDK (jni.h and javac); what runs here is the
generation: the interface must give a wrapper and Java classes that name
every function of the port's C header.
"""
import os
import re
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_tpu_torch")
SWIG_TIMEOUT_S = 120


def test_swig_interface_generates(tmp_path):
    if shutil.which("swig") is None:
        pytest.skip("swig is not installed")
    out_dir = tmp_path / "java"
    out_dir.mkdir()
    wrap = tmp_path / "lightgbm_tpu_torch_wrap.c"
    subprocess.run(
        ["swig", "-java", "-package", "io.lightgbm_tpu_torch",
         "-outdir", str(out_dir), "-o", str(wrap),
         os.path.join(PKG, "swig", "lightgbm_tpu_torch_lib.i")],
        check=True, timeout=SWIG_TIMEOUT_S)
    module = out_dir / "lightgbm_tpu_torchlib.java"
    assert module.exists()
    src = module.read_text()
    header = open(os.path.join(PKG, "capi",
                               "lightgbm_tpu_torch_c.h")).read()
    exported = re.findall(r"int (LGBM_\w+)\(", header)
    assert len(exported) >= 51
    missing = [fn for fn in exported if fn not in src]
    assert not missing, missing
    wrap_src = wrap.read_text()
    assert '#include "../capi/lightgbm_tpu_torch_c.h"' in wrap_src
    assert "LGBM_BoosterUpdateOneIter" in wrap_src
