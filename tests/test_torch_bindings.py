"""The binding shims over the port's C library (A8b's last item): the Perl
package ``perl-package/AI-MXNetTPU`` (XS over the C training API), the
JNI shim of ``scala-package`` and the R shim of ``R-package``, each
compiled against the port's ``libmxtpu_predict.so``
(``mxnet_tpu_torch/_capi.py``) with no file of theirs edited.

The Perl package is copied into a temporary tree whose
``mxnet_tpu/src/{build,include}`` are links to the port's library
directory and headers, the layout its ``Makefile.PL`` computes from
``../..``; ``tests/c/jni_shim_smoke.c`` and ``tests/c/r_shim_smoke.c``
(each includes its real shim) are built with their stub headers. Each
trains its MLP past 90 % on the CPU (``MXNET_DEFAULT_CONTEXT=cpu``) and
writes a checkpoint that the port's ``nd.load`` reads.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

import mxnet_tpu_torch as T
from mxnet_tpu_torch import _capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERL_PKG = os.path.join(ROOT, "perl-package", "AI-MXNetTPU")

needs_perl = pytest.mark.skipif(
    shutil.which("perl") is None or shutil.which("g++") is None
    or shutil.which("make") is None, reason="no perl or C++ toolchain")
needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None,
                               reason="no C toolchain")

# what a build of the Perl package leaves in its directory
_PERL_OUTPUTS = ("blib", "Makefile", "Makefile.old", "MXNetTPU.c",
                 "MXNetTPU.o", "MXNetTPU.bs", "pm_to_blib", "MYMETA.*",
                 "*.params", "*.json")


@pytest.fixture(scope="module")
def perl_run(tmp_path_factory):
    lib_dir = os.path.dirname(_capi.build())
    tmp = tmp_path_factory.mktemp("perl")
    src = tmp / "mxnet_tpu" / "src"
    src.mkdir(parents=True)
    os.symlink(lib_dir, src / "build")
    os.symlink(_capi.include_dir(), src / "include")
    pkg = tmp / "perl-package" / "AI-MXNetTPU"
    shutil.copytree(PERL_PKG, pkg, ignore=shutil.ignore_patterns(*_PERL_OUTPUTS))
    for cmd in (["perl", "Makefile.PL"], ["make"]):
        r = subprocess.run(cmd, cwd=pkg, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, (cmd, r.stdout[-2000:], r.stderr[-2000:])
    out_dir = str(tmp_path_factory.mktemp("perl_out"))
    env = _capi.client_env(cpu=True)
    env["MXTPU_PERL_OUT"] = out_dir
    r = subprocess.run(["make", "test", "TEST_VERBOSE=1"], cwd=pkg,
                       capture_output=True, text=True, env=env, timeout=900)
    return r, out_dir


@needs_perl
def test_perl_suite_passes_on_the_port(perl_run):
    r, _ = perl_run
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    out = r.stdout + r.stderr
    assert "perl-trained accuracy" in out and "push/pull round-trip" in out, out


@needs_perl
def test_port_loads_the_perl_checkpoint(perl_run):
    """The Perl-trained checkpoint scores the planted-signal task in the
    port's executor (the JAX package's test_perl_binding check)."""
    r, out_dir = perl_run
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    sym = T.sym.load(os.path.join(out_dir, "perlnet-symbol.json"))
    loaded = T.nd.load(os.path.join(out_dir, "perlnet-0001.params"))
    arg_params = {k[4:]: v for k, v in loaded.items() if k.startswith("arg:")}
    assert set(arg_params) == {"fc1_weight", "fc1_bias", "fc2_weight",
                               "fc2_bias"}
    with T.cpu():
        ex = sym.simple_bind(T.cpu(), data=(32, 8), softmax_label=(32,),
                             grad_req="null")
        for k, v in arg_params.items():
            ex.arg_dict[k][:] = v
        rng = np.random.RandomState(0)
        X = rng.uniform(-1, 1, (32, 8)).astype(np.float32)
        Y = (rng.uniform(size=32) > 0.5).astype(np.float32)
        X[Y > 0.5, :4] += 0.8
        X[Y < 0.5, 4:] += 0.8
        ex.arg_dict["data"][:] = X
        out = ex.forward(is_train=False)[0].asnumpy()
    acc = ((out[:, 1] > out[:, 0]).astype(np.float32) == Y).mean()
    assert acc > 0.85, acc


@needs_gcc
@pytest.mark.parametrize("shim,stub,params", [
    ("jni_shim_smoke.c", "jni_stub", "jni_shim_smoke.params"),
    ("r_shim_smoke.c", "r_stub", "r_shim_smoke.params"),
])
def test_shim_smoke_trains_on_the_port(shim, stub, params, tmp_path):
    """The JNI and R shims' C layers, unchanged, against the port's C
    library: the smoke trains its MLP past 90 % and its checkpoint loads in
    the port."""
    exe = str(tmp_path / "smoke")
    r = subprocess.run(
        ["gcc", "-O2", "-o", exe, os.path.join(ROOT, "tests", "c", shim),
         "-I", os.path.join(ROOT, "tests", "c", stub)]
        + _capi.client_flags() + ["-lm"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([exe, str(tmp_path)], capture_output=True, text=True,
                       env=_capi.client_env(cpu=True), timeout=600)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "OK" in r.stdout, r.stdout
    saved = T.nd.load(str(tmp_path / params))
    assert "arg:fc1_weight" in saved
    assert saved["arg:fc1_weight"].shape == (16, 10)
