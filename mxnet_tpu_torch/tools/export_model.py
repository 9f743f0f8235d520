"""Export a checkpoint to a Python-free ``.mxa`` artifact from the command
line (counterpart of ``tools/export_model.py``, with its subcommands and
flags).

Predict artifact from a trained checkpoint::

    python -m mxnet_tpu_torch.tools.export_model predict --prefix model \\
        --epoch 10 --shape data:1,3,224,224 --out model.mxa [--platform cpu]

Train artifact (optionally warm-started from a checkpoint)::

    python -m mxnet_tpu_torch.tools.export_model train \\
        --symbol model-symbol.json --shape data:32,3,224,224 \\
        --optimizer sgd --lr 0.05 --momentum 0.9 --out train.mxa \\
        [--prefix model --epoch 10] [--bf16] [--num-devices N]

``--num-devices N`` exports the data-parallel step over N positions (the
runtime trains it from the one file: on the CPU, or on the cards visible,
repeating them).

Both print the manifest summary; serve or train with
``libmxtpu_predict_native.so`` (``MXPredCreateFromFile`` /
``MXTrainNative*``; :mod:`mxnet_tpu_torch._predict_native` builds it).
``--platform`` defaults to the current device (the card, or the CPU under
``MXNET_DEFAULT_CONTEXT=cpu``); ``tpu``, the JAX tool's default, means the
same.
"""
import argparse
import json
import os

import mxnet_tpu_torch as mx


def parse_shapes(specs):
    shapes = {}
    for spec in specs:
        name, _, dims = spec.partition(":")
        if not dims:
            raise SystemExit("--shape must be name:d0,d1,... (got %r)" % spec)
        shapes[name] = tuple(int(d) for d in dims.split(","))
    return shapes


def load_net(args):
    if (args.prefix is None) != (args.epoch is None):
        raise SystemExit("--prefix and --epoch go together (a warm start "
                         "needs both; got only one)")
    if args.prefix is not None:
        with mx.cpu():
            return mx.model.load_checkpoint(args.prefix, args.epoch)
    if args.symbol:
        return mx.sym.load(args.symbol), {}, {}
    raise SystemExit("pass --prefix/--epoch (checkpoint) or --symbol (json)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Export .mxa deployment artifacts")
    ap.add_argument("kind", choices=["predict", "train"])
    ap.add_argument("--prefix", help="checkpoint prefix (model-symbol.json "
                    "+ model-%%04d.params)")
    ap.add_argument("--epoch", type=int)
    ap.add_argument("--symbol", help="bare symbol json (train from scratch)")
    ap.add_argument("--shape", action="append", required=True,
                    metavar="name:d0,d1,...",
                    help="input shape (repeatable)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--platform", default=None,
                    choices=["cuda", "gpu", "cpu", "tpu"],
                    help="recorded platform (default: the current device)")
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "default"],
                    help="matmul precision recorded in the manifest")
    # train-only
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=None)
    ap.add_argument("--wd", type=float, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (float32 masters) in the step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-devices", type=int, default=1,
                    help="data-parallel step over N positions (train only; "
                         "N must divide the batch)")
    a = ap.parse_args(argv)

    shapes = parse_shapes(a.shape)
    sym, arg_params, aux_params = load_net(a)

    if a.kind == "predict":
        # train-only flags dropped without a word would mislead
        dropped = [f for f, on in (
            ("--bf16", a.bf16), ("--momentum", a.momentum is not None),
            ("--wd", a.wd is not None),
            ("--optimizer", a.optimizer != "sgd"), ("--lr", a.lr != 0.01),
            ("--seed", a.seed != 0),
            ("--num-devices", a.num_devices != 1)) if on]
        if dropped:
            raise SystemExit("%s only apply to 'train' exports (predict "
                             "precision is --precision)" % ", ".join(dropped))
        if not arg_params:
            raise SystemExit("predict export needs a trained checkpoint "
                             "(--prefix/--epoch)")
        manifest = mx.export_predict_artifact(
            sym, arg_params, aux_params, shapes, a.out,
            platform=a.platform, matmul_precision=a.precision)
    else:
        opt_params = {"learning_rate": a.lr}
        if a.momentum is not None:
            opt_params["momentum"] = a.momentum
        if a.wd is not None:
            opt_params["wd"] = a.wd
        manifest = mx.export_train_artifact(
            sym, shapes, a.out, optimizer=a.optimizer,
            optimizer_params=opt_params,
            arg_params=arg_params or None, aux_params=aux_params or None,
            platform=a.platform, matmul_precision=a.precision,
            seed=a.seed,
            compute_dtype="bfloat16" if a.bf16 else None,
            num_devices=a.num_devices)

    summary = {
        "kind": manifest.get("kind", "predict"),
        "out": a.out,
        "bytes": os.path.getsize(a.out),
        "platform": manifest["platform"],
    }
    if a.kind == "predict":
        summary["inputs"] = [i["name"] for i in manifest["inputs"]]
        summary["outputs"] = [o["name"] for o in manifest["outputs"]]
    else:
        roles = [x["role"] for x in manifest["args"]]
        summary["params"] = roles.count("param")
        summary["state_slots"] = roles.count("state")
        summary["auxs"] = roles.count("aux")
        summary["optimizer"] = manifest["optimizer"]
        summary["compute_dtype"] = manifest["compute_dtype"]
        summary["num_devices"] = manifest["num_devices"]
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
