"""The port's cloud stages against the reference's: ``cloud/notify`` sends
the same JSON bodies to a ``localhost`` webhook stand-in, ``cloud/aws``
makes the same calls into a stand-in ``boto3`` (and raises the same
``ImportError`` without one), the CLI's ``--notify`` and ``--ec2_*``
and ``run_pipeline``'s S3 and webhook stages do what the reference's do,
and ``io/subproc_io`` writes and reads the same archives (a stand-in
``zstd`` command records its command lines). Nothing here leaves
``localhost``."""

import http.server
import inspect
import json
import logging
import os
import socket
import stat
import sys
import threading
import types
import urllib.error

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cloud import aws as ref_aws
from magellanmapper_tpu.cloud import notify as ref_notify
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import pipelines as ref_pipelines
from magellanmapper_tpu.io import subproc_io as ref_subproc_io
from magellanmapper_torch.cloud import aws, notify
from magellanmapper_torch.io import cli, np_io, pipelines, subproc_io

torch.set_num_threads(1)


# -- the webhook stand-in ------------------------------------------------------

class Webhook:
    """A ``localhost`` HTTP server that records each POST's path and JSON
    body and answers 200."""

    def __init__(self):
        self.bodies = []
        hook = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                hook.bodies.append((self.path, self.headers.get(
                    "Content-Type"), json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/hook"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def closed_port_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}/hook"


def test_notify_and_post_send_the_references_bodies(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("".join(f"line {i}\n" for i in range(30)))
    with Webhook() as hook:
        for mod in (notify, ref_notify):
            assert mod.notify(hook.url, "done") is True
            assert mod.notify(hook.url, "done", "attached text") is True
            assert mod.post(hook.url, "msg", str(log)).status == 200
            assert mod.post(hook.url, "no file", str(tmp_path / "x"))
            assert mod.post(hook.url, "plain").status == 200
    half = len(hook.bodies) // 2
    assert hook.bodies[:half] == hook.bodies[half:]
    assert hook.bodies[2][2]["attachments"][0]["text"].startswith("line 10")
    assert inspect.signature(notify.notify) == inspect.signature(
        ref_notify.notify)


def test_webhook_failures_as_reference():
    url = closed_port_url()
    assert notify.notify(url, "x") is ref_notify.notify(url, "x") is False
    for mod in (notify, ref_notify):
        with pytest.raises(urllib.error.URLError):
            mod.post(url, "x")


# -- the boto3 stand-in --------------------------------------------------------

class Boto3:
    """A stand-in ``boto3`` module that records every call made into it,
    with S3 objects held in memory."""

    def __init__(self, objects=None, bad_etag=False):
        self.calls = []
        self.objects = dict(objects or {})
        self.bad_etag = bad_etag
        self.session = types.SimpleNamespace(Session=lambda: self)

    def record(self, *call):
        self.calls.append(call)

    def resource(self, name):
        self.record("resource", name)
        return _EC2(self) if name == "ec2" else _S3(self)


class _Inst:
    def __init__(self, b, iid):
        self.b, self.id = b, iid
        self.instance_type, self.public_ip_address = "t3.micro", "10.0.0.1"

    def wait_until_running(self):
        self.b.record("wait_until_running", self.id)

    def load(self):
        self.b.record("load", self.id)


class _Instances:
    def __init__(self, b):
        self.b = b

    def filter(self, **kw):
        self.b.record("instances.filter", kw)
        b = self.b

        class Found(list):
            def terminate(self):
                b.record("terminate")
        return Found([_Inst(b, "i-1"), _Inst(b, "i-2")])


class _EC2:
    def __init__(self, b):
        self.b = b
        self.instances = _Instances(b)

    def create_instances(self, **kw):
        self.b.record("create_instances", kw)
        return [_Inst(self.b, f"i-{n}") for n in range(kw["MinCount"])]

    def Instance(self, iid):
        self.b.record("Instance", iid)
        return _Inst(self.b, iid)


class _Object:
    def __init__(self, b, bucket, key):
        self.b, self.bucket, self.key = b, bucket, key

    @property
    def e_tag(self):
        import hashlib
        data = self.b.objects.get((self.bucket, self.key), b"")
        md5 = hashlib.md5(data + (b"x" if self.b.bad_etag else b""))
        return f'"{md5.hexdigest()}"'

    def download_file(self, path):
        self.b.record("download_file", self.bucket, self.key,
                      os.path.basename(path))
        with open(path, "wb") as f:
            f.write(self.b.objects[(self.bucket, self.key)])

    def load(self):
        self.b.record("load", self.bucket, self.key)
        if (self.bucket, self.key) not in self.b.objects:
            raise KeyError(self.key)

    def delete(self):
        self.b.record("delete", self.bucket, self.key)


class _Bucket:
    def __init__(self, b, name):
        self.b, self.name = b, name
        bb = b

        class Objects:
            def filter(self, Prefix=""):
                bb.record("objects.filter", name, Prefix)
                return [types.SimpleNamespace(key=k) for (bk, k) in
                        sorted(bb.objects) if bk == name
                        and k.startswith(Prefix)]

        class Versions:
            def filter(self, Prefix=""):
                bb.record("object_versions.filter", name, Prefix)
                return types.SimpleNamespace(
                    delete=lambda: bb.record("versions.delete", Prefix))
        self.objects = Objects()
        self.object_versions = Versions()

    def upload_file(self, path, key):
        with open(path, "rb") as f:
            self.b.objects[(self.name, key)] = f.read()
        self.b.record("upload_file", self.name, os.path.basename(path), key)


class _S3:
    def __init__(self, b):
        self.b = b

    def Bucket(self, name):
        return _Bucket(self.b, name)

    def Object(self, bucket, key):
        return _Object(self.b, bucket, key)


@pytest.fixture
def boto3_stub(monkeypatch):
    """Install a fresh stand-in for each call of the returned function."""
    def install(**kw):
        stub = Boto3(**kw)
        monkeypatch.setitem(sys.modules, "boto3", stub)
        return stub
    return install


def aws_session(mod, tmp_path):
    """Each AWS call of ``mod`` once; returns what they returned."""
    local = tmp_path / "up.bin"
    local.write_bytes(b"payload")
    out = [mod.start_instances("ami-1", "m5.large"),
           mod.start_instances("ami-2", "t3", count=2, key_name="k",
                               SubnetId="s-1"),
           mod.list_instances(), mod.list_instances("stopped"),
           mod.terminate_instances(("i-1", "i-9")),
           mod.list_s3("bkt"), mod.list_s3("bkt", "a/"),
           mod.upload_s3(str(local), "bkt"),
           mod.upload_s3(str(local), "bkt", "a/c.bin"),
           mod.list_s3_bucket("bkt"), mod.list_s3_bucket("bkt", "a/"),
           os.path.basename(mod.download_s3(
               "bkt", "a/c.bin", str(tmp_path / "down.bin"))),
           (tmp_path / "down.bin").read_bytes(),
           os.path.basename(mod.download_s3_file(
               "bkt", "up.bin", str(tmp_path / "d2.bin"))),
           mod.upload_s3_file(str(local), "bkt", "z.bin"),
           sorted(mod.load_s3_file("bkt", ["a/c.bin", "nope"])),
           sorted(mod.load_s3_file("bkt", "z.bin")),
           mod.delete_s3_file("bkt", "z.bin"),
           mod.delete_s3_file("bkt", "a/", hard=True),
           mod.instance_info("i-7"), mod.instance_info("i-8", get_ip=True),
           mod.show_instances(), mod.split_s3_path("s3://b/a/k.npy"),
           mod.split_s3_path("b/a/k.npy"), mod.split_s3_path("k.npy"),
           mod.md5sum(str(local))]
    return out


def test_aws_calls_match_reference(tmp_path, boto3_stub):
    got_stub = boto3_stub()
    (tmp_path / "p").mkdir()
    got = aws_session(aws, tmp_path / "p")
    want_stub = boto3_stub()
    (tmp_path / "r").mkdir()
    want = aws_session(ref_aws, tmp_path / "r")
    assert got == want
    assert got_stub.calls == want_stub.calls
    assert got_stub.objects == want_stub.objects


def test_download_checks_the_md5_as_reference(tmp_path, boto3_stub):
    for mod in (aws, ref_aws):
        boto3_stub(objects={("b", "k"): b"abc"}, bad_etag=True)
        with pytest.raises(IOError, match="MD5 mismatch"):
            mod.download_s3("b", "k", str(tmp_path / "k"))


@pytest.mark.parametrize("call", [
    lambda m: m.list_instances(), lambda m: m.start_instances("a", "b"),
    lambda m: m.list_s3("b"), lambda m: m.delete_s3_file("b", "k"),
    lambda m: m.instance_info("i")])
def test_aws_without_boto3_raises_as_reference(monkeypatch, call):
    monkeypatch.setitem(sys.modules, "boto3", None)
    errs = []
    for mod in (aws, ref_aws):
        with pytest.raises(ImportError) as err:
            call(mod)
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "boto3" in errs[0]


# -- the command line --------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--ec2_start", "tag", "ami-42", "m5.large", "subnet-1", "sg-1", "mykey",
     "2"],
    ["--ec2_start", "tag", "ami-42", "m5.large"],
    ["--ec2_start", "ami_id=ami-3", "instance_type=t3", "key_name=k"],
    ["--ec2_list"], ["--ec2_list", "stopped"],
    ["--ec2_terminate", "i-1", "i-2"],
    ["--ec2_list", "--plot_2d", "bar_plot", "--img", "t.csv"],
    ["--img", "v.npy", "--proc", "detect", "--ec2_terminate", "i-3"],
])
def test_ec2_tasks_make_the_references_calls(argv, boto3_stub):
    outs, calls = [], []
    for mod, extra in ((cli, ["--device", "cpu"]), (ref_cli, [])):
        stub = boto3_stub()
        rc = mod.process_cli_args(argv + extra)
        assert rc.ec2_start == ref_cli.process_cli_args(argv).ec2_start
        if "--plot_2d" in argv:
            assert not cli.cloud_task(rc)
            continue
        outs.append(mod.process_tasks(rc))
        calls.append(stub.calls)
    assert outs[:1] == outs[1:] and calls[:1] == calls[1:]


def test_notify_task_posts_as_reference(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text("a\nb\nc\n")
    with Webhook() as hook:
        for mod, extra in ((cli, []), (ref_cli, [])):
            rc = mod.process_cli_args(
                ["--notify", hook.url, "done", str(log), "--img", "v.npy",
                 "--proc", "detect"] + extra)
            assert mod.process_tasks(rc).status == 200
        root = logging.getLogger()
        level = root.level
        try:
            assert cli.main(["--notify", hook.url]).status == 200
        finally:
            root.setLevel(level)
    assert hook.bodies[0] == hook.bodies[1]
    assert hook.bodies[0][2] == {"text": "done",
                                 "attachments": [{"text": "a\n\nb\n\nc\n"}]}
    assert hook.bodies[2][2] == {"text": ""}


# -- run_pipeline's cloud stages ---------------------------------------------

def write_volume(np_io_mod, path):
    vol = np.zeros((16, 40, 40), np.uint16)
    zz, yy, xx = np.indices(vol.shape)
    for c in ((8, 12, 12), (8, 28, 26)):
        vol[((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
            <= 9] = 1000
    np_io_mod.write_npy(path, vol[None])
    return vol


def test_pipeline_cloud_stages_as_reference(tmp_path, boto3_stub):
    """``run_pipeline("full", s3_bucket=..., notify_url=...)``: the image
    downloaded from the bucket when missing, each output compressed and
    uploaded, and the webhook naming the stages, in both packages."""
    runs = []
    with Webhook() as hook:
        for mod, np_mod, extra in ((pipelines, np_io, {"device": "cpu"}),
                                   (ref_pipelines, ref_np_io, {})):
            d = tmp_path / mod.__name__.split(".")[0]
            d.mkdir()
            img = str(d / "spec.npy")
            write_volume(np_mod, img)
            with open(np_mod.make_filenames(img)[0], "rb") as f:
                arr = f.read()
            stub = boto3_stub(objects={("bkt", "spec.npy"): arr})
            out = mod.run_pipeline("full", img, rescale=0.5,
                                   s3_bucket="bkt", notify_url=hook.url,
                                   **extra)
            runs.append(({k: os.path.relpath(v, d) if os.path.isabs(v)
                          else v for k, v in out.items()},
                         stub.calls, sorted(stub.objects)))
            # a missing image is downloaded by its base name first
            stub = boto3_stub(objects={("bkt", "gone.npy"): arr})
            out = mod.run_pipeline("download", str(d / "gone.npy"),
                                   s3_bucket="bkt", **extra)
            runs.append((stub.calls, {k: os.path.relpath(v, d)
                                      for k, v in out.items()},
                         (d / "gone.npy").read_bytes() == arr))
    assert runs[0] == runs[2] and runs[1] == runs[3]
    assert runs[1][1:] == ({"download": "gone.npy"}, True)
    msgs = [body["text"] for _, _, body in hook.bodies]
    assert len(msgs) == 2 and all("transformation" in m and "detection" in m
                                  for m in msgs)
    assert msgs[0].replace("magellanmapper_torch", "") == \
        msgs[1].replace("magellanmapper_tpu", "")


def test_pipeline_without_boto3_raises_as_reference(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    errs = []
    for mod, extra in ((pipelines, {"device": "cpu"}), (ref_pipelines, {})):
        with pytest.raises(ImportError) as err:
            mod.run_pipeline("download", str(tmp_path / "x.npy"),
                             s3_bucket="b", **extra)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


# -- compression ---------------------------------------------------------------

ZSTD = """#!/bin/sh
echo "$(basename "$0") $*" >> "{log}"
case " $* " in
  *" -t "*) exit 0 ;;
esac
in=""; out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    -*) shift ;;
    *) in="$1"; shift ;;
  esac
done
cp "$in" "$out"
"""


def fake_zstd(bin_dir, log):
    bin_dir.mkdir(exist_ok=True)
    for name in ("zstd", "pzstd"):
        path = bin_dir / name
        path.write_text(ZSTD.format(log=log))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.mark.parametrize("fmt", ["zip", "gz", "zstd", "zstd_dir",
                                 "zstd_tool"])
def test_compression_round_trips_match_reference(tmp_path, monkeypatch, fmt):
    data = np.random.default_rng(0).integers(0, 255, 4000, np.uint8)
    results = []
    for mod in (subproc_io, ref_subproc_io):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        if fmt == "zstd_tool":
            fake_zstd(tmp_path / "bin", str(d / "cmds.log"))
            monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep
                               + os.environ["PATH"])
        src = d / "data.bin"
        src.write_bytes(data.tobytes())
        if fmt == "zstd_dir":
            src = d / "tree"
            (src / "sub").mkdir(parents=True)
            (src / "a.txt").write_text("a")
            (src / "sub" / "b.txt").write_text("b")
        arc = mod.compress_file(
            str(src), fmt="zstd" if fmt.startswith("zstd") else fmt)
        out = mod.decompress_file(arc, str(d / "out"))
        files = sorted(os.path.relpath(os.path.join(r, f), d / "out")
                       for r, _, fs in os.walk(d / "out") for f in fs)
        contents = [open(os.path.join(d / "out", f), "rb").read()
                    for f in files]
        log = (d / "cmds.log").read_text().replace(str(d), "D") \
            if (d / "cmds.log").exists() else ""
        results.append((os.path.relpath(arc, d), os.path.relpath(out, d),
                        files, contents, mod.test_compression(arc), log))
        monkeypatch.undo()
    assert results[0] == results[1]
    if fmt == "zstd_tool":
        assert results[0][0] == "data.bin.zst" and "zstd -f" in results[0][5]
    elif fmt.startswith("zstd"):
        assert results[0][0].endswith(".zip")


def test_compression_errors_as_reference(tmp_path):
    (tmp_path / "f.txt").write_text("x")
    (tmp_path / "f.zst").write_bytes(b"x")
    for mod in (subproc_io, ref_subproc_io):
        with pytest.raises(ValueError, match="unknown compression format"):
            mod.compress_file(str(tmp_path / "f.txt"), fmt="bz2")
        with pytest.raises(ValueError, match="unknown archive type"):
            mod.decompress_file(str(tmp_path / "f.zst"))
        assert mod.test_compression(str(tmp_path / "f.zst"))
        assert not mod.test_compression(str(tmp_path / "missing.zst"))
