"""Checkpoint interchange between the PyTorch port and the JAX package, on
CPU: ``.params`` files (``nd.save``/``nd.load``) byte for byte, CRC footer
included, read both ways, with the same refusals of corrupt files; symbol
JSON files (``Symbol.save``/``load``) byte for byte; ``Module``
checkpoints written by either package read by the other with equal
parameters; and a JAX-written checkpoint served by the port's engine to
the JAX engine's tokens. Sizes are tiny (vocab 23, 2 layers, d 32).
"""
import importlib
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.serving import ServingConfig as JConfig
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving import model as jmodel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import ServingConfig, ServingEngine

JLM = importlib.import_module("mxnet_tpu.models.transformer_lm")
TLM = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")

LM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48)
SEQ = 16
B = 4


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "h": rng.randn(5).astype(np.float16),
            "i": rng.randint(-9, 9, (2, 2, 2)).astype(np.int32),
            "b": rng.randint(-9, 9, (4,)).astype(np.int8),
            "u": rng.randint(0, 255, (7,)).astype(np.uint8)}


def _both(kind, seed=0):
    """The same data as JAX NDArrays and as port NDArrays (host)."""
    arrays = _arrays(seed)
    if kind == "bf16":
        x = np.random.RandomState(seed).randn(2, 3).astype(np.float32)
        import jax.numpy as jnp

        return ({"x": jmx.nd.array(x, dtype=jnp.bfloat16)},
                {"x": tmx.nd.NDArray(torch.from_numpy(x).bfloat16())})
    j = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    t = {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
         for k, v in arrays.items()}
    if kind == "list":
        return list(j.values()), list(t.values())
    return j, t


def _values(loaded):
    items = loaded.items() if isinstance(loaded, dict) else enumerate(loaded)
    return {k: v.asnumpy() for k, v in items}


# ------------------------------------------------------------ .params files
@pytest.mark.parametrize("kind", ["dict", "list", "bf16"])
def test_params_files_byte_identical_and_read_both_ways(tmp_path, kind):
    """bf16 is widened to float32 on save by both packages."""
    jdata, tdata = _both(kind)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, jdata)
    tmx.nd.save(tpath, tdata)
    tbytes = open(tpath, "rb").read()
    assert tbytes == open(jpath, "rb").read()
    assert tbytes[-16:-12] == b"MXCR"        # the CRC footer
    want = _values(jmx.nd.load(jpath))
    for got in (_values(tmx.nd.load(jpath)), _values(jmx.nd.load(tpath)),
                _values(tmx.nd.load(tpath))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert all(v.context == tmx.cpu() for v in
               (tmx.nd.load(jpath).values() if kind != "list"
                else tmx.nd.load(jpath)))


def _legacy_blob():
    """A pre-V1 record (no per-array magic: the first u32 is ndim)."""
    body = struct.pack("<QQQ", 0x112, 0, 1)
    body += struct.pack("<III", 2, 2, 3) + struct.pack("<iii", 1, 0, 0)
    body += np.arange(6, dtype=np.float32).tobytes()
    return body + struct.pack("<Q", 0)


def _corrupt(case, good):
    if case == "flipped_byte":          # the CRC footer catches it
        b = bytearray(good)
        b[40] ^= 0xFF
        return bytes(b)
    if case == "bad_list_magic":
        return struct.pack("<QQQ", 0x113, 0, 0)
    if case == "legacy_implausible_ndim":
        return struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<I", 1000) \
            + b"\0" * 64
    if case == "prerelease_layout":
        return struct.pack("<QQQQ", 0x112, 0, 1, 1) \
            + struct.pack("<I", 0xF993FAC8) + b"\0" * 32
    assert case == "unknown_type_flag"
    legacy = bytearray(_legacy_blob())
    struct.pack_into("<i", legacy, 24 + 12 + 8, 42)
    return bytes(legacy)


@pytest.mark.parametrize("case", ["flipped_byte", "bad_list_magic",
                                  "legacy_implausible_ndim",
                                  "prerelease_layout", "unknown_type_flag"])
def test_corrupt_params_files_raise_in_both(tmp_path, case):
    good = tmp_path / "good.params"
    jmx.nd.save(str(good), _both("dict")[0])
    bad = tmp_path / "bad.params"
    bad.write_bytes(_corrupt(case, good.read_bytes()))
    with pytest.raises(JError):
        jmx.nd.load(str(bad))
    with pytest.raises(MXNetError):
        tmx.nd.load(str(bad))


def test_legacy_header_loads_in_both(tmp_path):
    path = tmp_path / "legacy.params"
    path.write_bytes(_legacy_blob())
    (j,), (t,) = jmx.nd.load(str(path)), tmx.nd.load(str(path))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(
        t.asnumpy(), np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(MXNetError, match="0-dim"):
        tmx.nd.save(str(tmp_path / "x.params"),
                    [tmx.nd.NDArray(torch.zeros(()))])


# ------------------------------------------------------------ symbol files
def test_symbol_files_byte_identical_and_read_both_ways(tmp_path):
    with jmx.name.NameManager():
        js = JLM.get_symbol(seq_len=SEQ, **LM)
    with tmx.name.NameManager():
        ts = TLM.get_symbol(seq_len=SEQ, **LM)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    js.save(jpath)
    ts.save(tpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert tmx.sym.load(jpath).tojson() == js.tojson()
    assert jmx.sym.load(tpath).tojson() == ts.tojson()


# ------------------------------------------------------- module checkpoints
def _lm_data(n=8, seed=1):
    rng = np.random.RandomState(seed)
    X = (rng.randint(0, LM["vocab_size"], (n, 1)) + np.arange(SEQ)) \
        % LM["vocab_size"]
    return X.astype(np.float32), ((X + 1) % LM["vocab_size"]).astype(np.float32)


def _fit_two_steps(mx, lm_module):
    """Module.fit for one epoch of two batches (Adam, seeded init)."""
    with mx.name.NameManager():
        sym = lm_module.get_symbol(seq_len=SEQ, **LM)
    X, Y = _lm_data()
    rng = np.random.RandomState(0)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(B, SEQ),
                                      softmax_label=(B, SEQ))[0]))
    params = {n: mx.nd.array((rng.randn(*s) * 0.1).astype(np.float32),
                             ctx=mx.cpu())
              for n, s in shapes.items() if n not in ("data", "softmax_label")}
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
            optimizer="adam", optimizer_params={"learning_rate": 3e-3},
            arg_params=params)
    return mod, {n: v.asnumpy() for n, v in params.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_module_checkpoint_read_by_the_other_package(tmp_path, writer):
    """Two fit steps, ``Module.save_checkpoint``, then the other package's
    ``model.load_checkpoint`` and ``Module.load``: equal parameters and
    the same symbol."""
    src_mx, src_lm, dst_mx = ((tmx, TLM, jmx) if writer == "port"
                              else (jmx, JLM, tmx))
    mod, init = _fit_two_steps(src_mx, src_lm)
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 2)
    want = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    assert any(not np.array_equal(want[n], init[n]) for n in init), \
        "fit did not move the parameters"
    sym, args, auxs = dst_mx.model.load_checkpoint(prefix, 2)
    assert sym.tojson() == mod.symbol.tojson() and auxs == {}
    assert sorted(args) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(args[n].asnumpy(), want[n], err_msg=n)
    loaded = dst_mx.mod.Module.load(prefix, 2, context=dst_mx.cpu())
    loaded.bind(data_shapes=[("data", (B, SEQ))],
                label_shapes=[("softmax_label", (B, SEQ))])
    got = loaded.get_params()[0]
    for n in want:
        np.testing.assert_array_equal(got[n].asnumpy(), want[n], err_msg=n)


def test_module_params_round_trip_and_unported_options(tmp_path):
    mod, _ = _fit_two_steps(tmx, TLM)
    path = str(tmp_path / "p.params")
    mod.save_params(path)
    want = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    mod.set_params({n: np.zeros_like(v) for n, v in want.items()}, {})
    mod.load_params(path)
    for n, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), want[n], err_msg=n)
    with pytest.raises(MXNetError, match="optimizer-state"):
        mod.save_checkpoint(str(tmp_path / "x"), 1, save_optimizer_states=True)
    with pytest.raises(MXNetError, match="optimizer-state"):
        tmx.mod.Module.load(str(tmp_path / "x"), 1, load_optimizer_states=True)


# ---------------------------------------------------- checkpoint -> serving
SERVE = dict(LM, max_len=32)


def _serving_config(cls, **over):
    kw = dict(SERVE, block_size=8, num_blocks=64, max_batch=8,
              prefills_per_step=4, prefix_cache=False, max_queue=0,
              default_timeout_ms=0)
    kw.update(over)
    return cls(**kw)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_jax_checkpoint_serves_in_the_port(tmp_path, spec_k):
    """The JAX package writes a checkpoint of the serving LM; the port's
    ``load_checkpoint`` carries it into ``ServingEngine`` (target-only and
    speculative), which gives the JAX engine's tokens on the same
    checkpoint."""
    cfg = _serving_config(JConfig)
    with jmx.name.NameManager():
        sym = JLM.get_symbol(seq_len=SERVE["max_len"], **LM)
    params = {n: jmx.nd.array(v) for n, v in
              jmodel.random_params(cfg, seed=5).items()}
    prefix = str(tmp_path / "serve")
    jmx.model.save_checkpoint(prefix, 0, sym, params, {})
    _, jargs, _ = jmx.model.load_checkpoint(prefix, 0)
    _, targs, _ = tmx.model.load_checkpoint(prefix, 0)
    rng = np.random.RandomState(11)
    prompts = [[int(x) for x in rng.randint(0, LM["vocab_size"],
                                            rng.randint(1, 14))]
               for _ in range(5)]
    want = JEngine(cfg, arg_params=jargs).generate(prompts, 8)
    eng = ServingEngine(_serving_config(ServingConfig, spec_k=spec_k),
                        arg_params=targs, device="cpu")
    assert eng.generate(prompts, 8) == want
