"""Pack an image folder or list into RecordIO — the port's twin of the
repository's ``tools/im2rec.py`` (reference: tools/im2rec.py and the C++
tools/im2rec.cc), with its flags:

    python3 -m mxnet_tpu_torch.tools.im2rec prefix root --list   # prefix.lst
    python3 -m mxnet_tpu_torch.tools.im2rec prefix root          # .lst -> .rec/.idx

Images are read and encoded with PIL; the files are those of the JAX
package's tool, byte for byte, for the same inputs.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from mxnet_tpu_torch import recordio


def list_image(root, recursive, exts):
    """(reference: im2rec.py list_image)"""
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and (suffix in exts):
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
        for k, v in sorted(cat.items(), key=lambda x: x[1]):
            print(os.path.relpath(k, root), v)
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and (suffix in exts):
                yield (i, os.path.relpath(fpath, root), 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, "w") as fout:
        for i, item in enumerate(image_list):
            line = "%d\t" % item[0]
            for j in item[2:]:
                line += "%f\t" % j
            line += "%s\n" % item[1]
            fout.write(line)


def read_list(path_in):
    with open(path_in) as fin:
        while True:
            line = fin.readline()
            if not line:
                break
            line = [i.strip() for i in line.strip().split("\t")]
            line_len = len(line)
            if line_len < 3:
                print("lst should at least has three parts, but only has %s parts for %s" % (line_len, line))
                continue
            item = [int(line[0])] + [line[-1]] + [float(i) for i in line[1:-1]]
            yield item


def image_encode(args, i, item, color, quality, encoding):
    from PIL import Image

    fullpath = os.path.join(args.root, item[1])
    try:
        img = Image.open(fullpath)
    except Exception as e:  # noqa: BLE001
        print("imread error trying to load file: %s: %s" % (fullpath, e))
        return None
    if color == 0:
        img = img.convert("L")
    else:
        img = img.convert("RGB")
    if args.resize:
        w, h = img.size
        if w > h:
            img = img.resize((args.resize * w // h, args.resize), Image.BILINEAR)
        else:
            img = img.resize((args.resize, args.resize * h // w), Image.BILINEAR)
    if args.center_crop:
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    import io as _io

    bio = _io.BytesIO()
    fmt = "JPEG" if encoding in (".jpg", ".jpeg") else "PNG"
    img.save(bio, format=fmt, quality=quality)
    if len(item) > 3 and args.pack_label:
        header = recordio.IRHeader(0, np.asarray(item[2:], np.float32), item[0], 0)
    else:
        header = recordio.IRHeader(0, item[2], item[0], 0)
    return recordio.pack(header, bio.getvalue())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Create an image list or rec database by traversing image folders."
    )
    parser.add_argument("prefix", help="prefix of input/output lst and rec files.")
    parser.add_argument("root", help="path to folder containing images.")
    cgroup = parser.add_argument_group("Options for creating image lists")
    cgroup.add_argument("--list", action="store_true", help="create image list.")
    cgroup.add_argument("--exts", nargs="+", default=[".jpeg", ".jpg", ".png"])
    cgroup.add_argument("--chunks", type=int, default=1)
    cgroup.add_argument("--train-ratio", type=float, default=1.0)
    cgroup.add_argument("--test-ratio", type=float, default=0)
    cgroup.add_argument("--recursive", action="store_true")
    cgroup.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    rgroup = parser.add_argument_group("Options for creating database")
    rgroup.add_argument("--pass-through", action="store_true", help="skip transcode")
    rgroup.add_argument("--resize", type=int, default=0)
    rgroup.add_argument("--center-crop", action="store_true")
    rgroup.add_argument("--quality", type=int, default=95)
    rgroup.add_argument("--color", type=int, default=1, choices=[-1, 0, 1])
    rgroup.add_argument("--encoding", type=str, default=".jpg", choices=[".jpg", ".png"])
    rgroup.add_argument("--pack-label", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.list:
        image_list = list(list_image(args.root, args.recursive, args.exts))
        if args.shuffle:
            random.seed(100)
            random.shuffle(image_list)
        N = len(image_list)
        chunk_size = (N + args.chunks - 1) // args.chunks
        for i in range(args.chunks):
            chunk = image_list[i * chunk_size : (i + 1) * chunk_size]
            str_chunk = "_%dof%d" % (i, args.chunks) if args.chunks > 1 else ""
            sep = int(chunk_size * args.train_ratio)
            sep_test = int(chunk_size * args.test_ratio)
            if args.train_ratio == 1.0:
                write_list(args.prefix + str_chunk + ".lst", chunk)
            else:
                if args.test_ratio:
                    write_list(args.prefix + str_chunk + "_test.lst", chunk[:sep_test])
                if args.train_ratio + args.test_ratio < 1.0:
                    write_list(args.prefix + str_chunk + "_val.lst", chunk[sep + sep_test :])
                write_list(args.prefix + str_chunk + "_train.lst", chunk[sep_test : sep_test + sep])
        return
    files = [
        os.path.join(os.path.dirname(args.prefix) or ".", f)
        for f in os.listdir(os.path.dirname(args.prefix) or ".")
        if f.startswith(os.path.basename(args.prefix)) and f.endswith(".lst")
    ]
    for fname in files:
        print("Creating .rec file from", fname)
        base = os.path.splitext(fname)[0]
        record = recordio.MXIndexedRecordIO(base + ".idx", base + ".rec", "w")
        count = 0
        for item in read_list(fname):
            if args.pass_through:
                with open(os.path.join(args.root, item[1]), "rb") as fin:
                    header = recordio.IRHeader(0, item[2], item[0], 0)
                    s = recordio.pack(header, fin.read())
            else:
                s = image_encode(args, count, item, args.color, args.quality, args.encoding)
            if s is None:
                continue
            record.write_idx(item[0], s)
            count += 1
            if count % 1000 == 0:
                print("processed", count)
        record.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
