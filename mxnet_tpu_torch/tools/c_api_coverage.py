"""The C API coverage manifest of the port,
``mxnet_tpu_torch/docs/c_api_coverage.md`` (the port's counterpart of
``tools/c_api_coverage.py``): one row per function the reference declares
in ``include/mxnet/c_api.h`` and ``c_predict_api.h``, classified against
the symbols the port's C libraries export (``nm -D`` over
``libmxtpu_predict.so``, built by ``mxnet_tpu_torch/_capi.py``, and
``libmxtpu_predict_native.so``, built by ``_predict_native.py``):

* **implemented** — the exact symbol is exported;
* **equivalent** — covered by a differently shaped exported function;
* **descoped** — deliberately not provided, with the reason.

The reference headers are on no machine the port runs on, so the 128
declarations ``(name, header)`` are kept here, in the headers' order. A
declaration neither exported nor in ``MAPPED`` fails the run.

Run: ``python -m mxnet_tpu_torch.tools.c_api_coverage [--check]
[--device cpu]`` (writes the manifest; ``--check`` exits 1 on drift
instead). The libraries are built first where they are not.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import _device

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "c_api_coverage.md")

# the reference's declarations, header by header, in their order
C_API_H = (
    "MXGetLastError", "MXRandomSeed", "MXNotifyShutdown",
    "MXSetProfilerConfig", "MXSetProfilerState", "MXDumpProfile",
    "MXSetNumOMPThreads", "MXNDArrayCreateNone", "MXNDArrayCreate",
    "MXNDArrayCreateEx", "MXNDArrayLoadFromRawBytes", "MXNDArraySaveRawBytes",
    "MXNDArraySave", "MXNDArrayLoad", "MXNDArraySyncCopyFromCPU",
    "MXNDArraySyncCopyToCPU", "MXNDArrayWaitToRead", "MXNDArrayWaitToWrite",
    "MXNDArrayWaitAll", "MXNDArrayFree", "MXNDArraySlice", "MXNDArrayAt",
    "MXNDArrayReshape", "MXNDArrayGetShape", "MXNDArrayGetData",
    "MXNDArrayGetDType", "MXNDArrayGetContext", "MXListFunctions",
    "MXGetFunction", "MXFuncGetInfo", "MXFuncDescribe", "MXFuncInvoke",
    "MXFuncInvokeEx", "MXImperativeInvoke", "MXAutogradSetIsTraining",
    "MXAutogradMarkVariables", "MXAutogradComputeGradient", "MXListAllOpNames",
    "MXSymbolListAtomicSymbolCreators", "MXSymbolGetAtomicSymbolName",
    "MXSymbolGetAtomicSymbolInfo", "MXSymbolCreateAtomicSymbol",
    "MXSymbolCreateVariable", "MXSymbolCreateGroup", "MXSymbolCreateFromFile",
    "MXSymbolCreateFromJSON", "MXSymbolSaveToFile", "MXSymbolSaveToJSON",
    "MXSymbolFree", "MXSymbolCopy", "MXSymbolPrint", "MXSymbolGetName",
    "MXSymbolGetAttr", "MXSymbolSetAttr", "MXSymbolListAttr",
    "MXSymbolListAttrShallow", "MXSymbolListArguments", "MXSymbolListOutputs",
    "MXSymbolGetInternals", "MXSymbolGetChildren", "MXSymbolGetOutput",
    "MXSymbolListAuxiliaryStates", "MXSymbolCompose", "MXSymbolGrad",
    "MXSymbolInferShape", "MXSymbolInferShapePartial", "MXSymbolInferType",
    "MXExecutorFree", "MXExecutorPrint", "MXExecutorForward",
    "MXExecutorBackward", "MXExecutorOutputs", "MXExecutorBind",
    "MXExecutorBindX", "MXExecutorBindEX", "MXExecutorSetMonitorCallback",
    "MXListDataIters", "MXDataIterCreateIter", "MXDataIterGetIterInfo",
    "MXDataIterFree", "MXDataIterNext", "MXDataIterBeforeFirst",
    "MXDataIterGetData", "MXDataIterGetIndex", "MXDataIterGetPadNum",
    "MXDataIterGetLabel", "MXInitPSEnv", "MXKVStoreCreate", "MXKVStoreFree",
    "MXKVStoreInit", "MXKVStorePush", "MXKVStorePull", "MXKVStoreSetUpdater",
    "MXKVStoreGetType", "MXKVStoreGetRank", "MXKVStoreGetGroupSize",
    "MXKVStoreIsWorkerNode", "MXKVStoreIsServerNode",
    "MXKVStoreIsSchedulerNode", "MXKVStoreBarrier",
    "MXKVStoreSetBarrierBeforeExit", "MXKVStoreRunServer",
    "MXKVStoreSendCommmandToServers", "MXKVStoreGetNumDeadNode",
    "MXRecordIOWriterCreate", "MXRecordIOWriterFree",
    "MXRecordIOWriterWriteRecord", "MXRecordIOWriterTell",
    "MXRecordIOReaderCreate", "MXRecordIOReaderFree",
    "MXRecordIOReaderReadRecord", "MXRecordIOReaderSeek", "MXRtcCreate",
    "MXRtcPush", "MXRtcFree", "MXCustomOpRegister",
)
C_PREDICT_API_H = (
    "MXGetLastError", "MXPredCreate", "MXPredCreatePartialOut",
    "MXPredGetOutputShape", "MXPredSetInput", "MXPredForward",
    "MXPredPartialForward", "MXPredGetOutput", "MXPredFree", "MXNDListCreate",
    "MXNDListGet", "MXNDListFree",
)
REFERENCE = ([(n, "c_api.h") for n in C_API_H]
             + [(n, "c_predict_api.h") for n in C_PREDICT_API_H])

# name -> (status, note) for the declarations NOT exported under their own
# name; every other exported one is implemented
MAPPED = {
    # the legacy Function API: superseded by MXImperativeInvoke in the
    # reference itself (c_api.h:518); the successor is what ships
    "MXListFunctions": ("equivalent",
                        "legacy Function API -> `MXListAllOpNames` + "
                        "`MXImperativeInvoke`"),
    "MXGetFunction": ("equivalent", "see `MXListFunctions`"),
    "MXFuncGetInfo": ("equivalent",
                      "see `MXSymbolGetAtomicSymbolInfo` (same metadata)"),
    "MXFuncDescribe": ("equivalent", "see `MXListFunctions`"),
    "MXFuncInvoke": ("equivalent", "see `MXImperativeInvoke`"),
    "MXFuncInvokeEx": ("equivalent", "see `MXImperativeInvoke`"),
    # symbol composition: the fused creator covers both steps
    "MXSymbolCreateAtomicSymbol": (
        "equivalent",
        "`MXSymbolCreateFromOperator` fuses create+compose (cpp-package's "
        "Operator::CreateSymbol always runs both back-to-back)"),
    "MXSymbolCompose": ("equivalent", "see `MXSymbolCreateAtomicSymbol`"),
    "MXSymbolGrad": (
        "descoped",
        "deprecated in the reference (c_api.h:930 'not fully supported'); "
        "gradients come from bind-time autodiff (`MXExecutorBackward`)"),
    # executor bind variants: one shape-driven entry point
    "MXExecutorBind": ("equivalent",
                       "`MXExecutorSimpleBindLite` (shape-driven bind + "
                       "in-library allocation; the reference's three bind "
                       "variants differ only in how arrays arrive)"),
    "MXExecutorBindX": ("equivalent", "see `MXExecutorBind`"),
    "MXExecutorBindEX": ("equivalent", "see `MXExecutorBind`"),
    "MXSetNumOMPThreads": (
        "descoped",
        "host threading is torch's (`torch.set_num_threads`, "
        "`OMP_NUM_THREADS`); a per-engine OMP knob has no analog"),
    "MXDataIterGetIndex": (
        "descoped",
        "per-batch source indices are not tracked by the port's iterators; "
        "`MXDataIterGetPadNum` covers the pad contract"),
    "MXDataIterGetIterInfo": (
        "descoped",
        "iterator metadata is Python-side (`mx.io` docstrings); C clients "
        "get the list via `MXListDataIters` and pass params as strings"),
    "MXKVStoreSetUpdater": (
        "descoped",
        "C-callback updaters would run host-side per key; updates run "
        "in-framework instead (`MXExecutorSGDUpdate`/`MomentumUpdate`, or "
        "a pickled optimizer on the server via Python `set_optimizer`)"),
    "MXKVStoreRunServer": (
        "descoped",
        "server processes bootstrap on import when DMLC_ROLE=server "
        "(kvstore_server.py, mirroring the reference's "
        "_init_kvstore_server_module flow); a C server loop would "
        "duplicate that"),
    "MXKVStoreSetBarrierBeforeExit": (
        "descoped",
        "exit barriers are handled by the server bootstrap's shutdown "
        "path; no C client knob needed"),
    "MXCustomOpRegister": (
        "descoped",
        "custom ops are the Python `mx.operator.CustomOp` escape hatch; a "
        "C-callback op would run outside the captured CUDA graphs — "
        "`MXRtcCreate/Push` is the C-side custom-kernel path"),
}


def libraries():
    """The two libraries' paths, built where they are not."""
    from .. import _capi, _predict_native

    return [_capi.build(), _predict_native.build()]


def exported_symbols(libs):
    """``{symbol: [library basename, ...]}`` of the global text symbols
    ``nm -D`` lists."""
    syms = {}
    for lib in libs:
        out = subprocess.run(["nm", "-D", lib], capture_output=True,
                             text=True, check=True).stdout
        base = os.path.basename(lib)
        for line in out.splitlines():
            parts = line.split()
            if len(parts) == 3 and parts[1] == "T":
                syms.setdefault(parts[2], []).append(base)
    return syms


def classify(syms):
    """``[(name, header, status, note)]`` over :data:`REFERENCE`, and the
    counts by status; an unclassified declaration raises."""
    rows, unclassified = [], []
    counts = {"implemented": 0, "equivalent": 0, "descoped": 0}
    for name, header in REFERENCE:
        if name in syms:
            status, note = "implemented", ", ".join(sorted(set(syms[name])))
        elif name in MAPPED:
            status, note = MAPPED[name]
        else:
            unclassified.append(name)
            continue
        counts[status] += 1
        rows.append((name, header, status, note))
    if unclassified:
        raise SystemExit(
            "unclassified reference C API functions (add to MAPPED or "
            "implement): %s" % unclassified)
    return rows, counts


def render(rows, counts):
    lines = [
        "# C API coverage manifest (the PyTorch/CUDA port)",
        "",
        "Generated by `python -m mxnet_tpu_torch.tools.c_api_coverage` "
        "(`--check` fails on drift). One row per function declared in the "
        "reference's `include/mxnet/c_api.h` + `c_predict_api.h`, against "
        "the port's `libmxtpu_predict.so` and `libmxtpu_predict_native.so`.",
        "",
        "**%d implemented / %d equivalent / %d descoped** of %d reference "
        "declarations." % (counts["implemented"], counts["equivalent"],
                           counts["descoped"], len(REFERENCE)),
        "",
        "| Function | Header | Status | Where / why |",
        "|---|---|---|---|",
    ]
    for name, header, status, note in rows:
        lines.append("| `%s` | %s | %s | %s |" % (name, header, status, note))
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the manifest on disk differs")
    _device.add_argument(ap)
    a = ap.parse_args(argv)
    dev = _device.resolve(a.device)
    rows, counts = classify(exported_symbols(libraries()))
    text = render(rows, counts)
    rec = dict({"tool": "c_api_coverage", "out": OUT,
                "declarations": len(REFERENCE)}, **counts)
    rec.update(_device.fields(dev))
    if a.check:
        current = open(OUT).read() if os.path.exists(OUT) else ""
        rec["up_to_date"] = current == text
        print(json.dumps(rec), flush=True)
        if not rec["up_to_date"]:
            print("%s is stale; run `python -m "
                  "mxnet_tpu_torch.tools.c_api_coverage`" % OUT,
                  file=sys.stderr)
            return 1
        return 0
    with open(OUT, "w") as f:
        f.write(text)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
