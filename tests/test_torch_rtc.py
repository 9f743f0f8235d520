"""``mx.rtc`` of the port against the JAX package's, on the CPU.

The same kernel bodies (arithmetic text valid in both packages, and
bodies over each package's own array module) pushed through both ``Rtc``
classes on the same seeded inputs agree within 1e-6; the error messages
are the JAX package's; the first push at each signature is a compile of
program ``rtc.<name>`` in the registry, later pushes its runs.
"""
import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-6


def _arrays(pkg, *shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [pkg.nd.array(rs.randn(*s).astype(np.float32), ctx=pkg.cpu())
            for s in shapes]


# (inputs, outputs, body): the body text is identical in both packages,
# or a pair of texts over jnp and torch
_CASES = [
    (("x",), ("y",), "y = x * 2 + 1"),
    (("a", "b"), ("s", "d"), "s = a + b\nd = (a - b) * 0.5"),
    (("x",), ("y",), "t = x * x\ny = t / (1 + t)"),
    (("x",), ("y",), ("y = jnp.tanh(x) + jnp.exp(-x * x)",
                      "y = torch.tanh(x) + torch.exp(-x * x)")),
    (("a", "b"), ("y",), ("y = jnp.maximum(a, b) - jnp.minimum(a, b)",
                          "y = torch.maximum(a, b) - torch.minimum(a, b)")),
]


@pytest.mark.parametrize("ins,outs,body", _CASES,
                         ids=["affine", "two_outputs", "multiline",
                              "transcendental", "maxmin"])
def test_rtc_push_matches_the_jax_package(ins, outs, body):
    jbody, tbody = (body, body) if isinstance(body, str) else body
    got = {}
    for pkg, text in ((J, jbody), (T, tbody)):
        xs = _arrays(pkg, *([(4, 5)] * len(ins)))
        ys = [pkg.nd.zeros((4, 5), ctx=pkg.cpu()) for _ in outs]
        k = pkg.rtc.Rtc("k_%s" % "_".join(outs), list(zip(ins, xs)),
                        list(zip(outs, ys)), text)
        k.push(xs, ys, grid_dims=(1, 1, 1), block_dims=(32, 1, 1))
        got[pkg] = [y.asnumpy() for y in ys]
    for a, b in zip(got[T], got[J]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_rtc_affine_is_exact_on_the_cpu():
    x, = _arrays(T, (7, 3))
    y = T.nd.zeros((7, 3), ctx=T.cpu())
    T.rtc.Rtc("affine", [("x", x)], [("y", y)], "y = x * 2 + 1").push([x], [y])
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy() * 2 + 1)


def _messages(pkg):
    out = []
    with pytest.raises(pkg.base.MXNetError) as e:
        pkg.rtc.Rtc("noout", [("x", None)], [], "pass")
    out.append(str(e.value))
    x = pkg.nd.ones((3,), ctx=pkg.cpu())
    y = pkg.nd.zeros((3,), ctx=pkg.cpu())
    k = pkg.rtc.Rtc("arity", [("x", x)], [("y", y)], "y = x")
    with pytest.raises(pkg.base.MXNetError) as e:
        k.push([x, x], [y])
    out.append(str(e.value))
    k = pkg.rtc.Rtc("shape", [("x", x)], [("y", y)], "y = x[:2]")
    with pytest.raises(pkg.base.MXNetError) as e:
        k.push([x], [y])
    out.append(str(e.value))
    k = pkg.rtc.Rtc("syntax", [("x", x)], [("y", y)], "y = = x")
    with pytest.raises(pkg.base.MXNetError) as e:
        k.push([x], [y])
    out.append(str(e.value).split(":")[0])
    return out


def test_rtc_error_messages_match_the_jax_package():
    t, j = _messages(T), _messages(J)
    assert t == j
    assert t[0] == "Rtc kernel needs at least one output"
    assert t[1] == "Rtc kernel 'arity' expects 1 inputs / 1 outputs, got 2 / 1"
    assert t[2] == ("Rtc kernel 'shape' output 'y' computed shape (2,) but "
                    "the bound array is (3,)")
    assert t[3] == "Rtc kernel 'syntax' failed to compile"


def test_rtc_is_a_compile_registry_program():
    x = T.nd.ones((6,), ctx=T.cpu())
    y = T.nd.zeros((6,), ctx=T.cpu())
    k = T.rtc.Rtc("registry_probe", [("x", x)], [("y", y)], "y = x + 3")
    for _ in range(3):
        k.push([x], [y])
    x2 = T.nd.ones((2, 6), ctx=T.cpu())
    y2 = T.nd.zeros((2, 6), ctx=T.cpu())
    k.push([x2], [y2])
    row = [r for r in T.compileobs.program_table()
           if r["program"] == "rtc.registry_probe"][0]
    assert row["compile_count"] == 2 and row["run_count"] == 2
    assert row["recompile_count"] == 1
    assert row["site"] == "mxnet_tpu_torch/rtc.py:Rtc._compile"
    np.testing.assert_array_equal(y2.asnumpy(), 4.0)


def test_rtc_runs_where_its_inputs_lie():
    x = T.nd.ones((3,), ctx=T.cpu())
    y = T.nd.zeros((3,), ctx=T.cpu())
    with pytest.raises(MXNetError, match="failed"):
        T.rtc.Rtc("bad", [("x", x)], [("y", y)],
                  "y = no_such_name(x)").push([x], [y])
    assert T.rtc.Rtc("ok", [("x", x)], [("y", y)], "y = x - 1").push(
        [x], [y])[0] is y
    assert y.context == T.cpu() and y.asnumpy().tolist() == [0, 0, 0]
