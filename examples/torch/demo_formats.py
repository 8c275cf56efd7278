#!/usr/bin/env python
"""Format-matrix demo on the PyTorch port: build one file of each asked
proprietary container from its on-disk spec, import each through the
CLI, and verify the voxels round-trip into memmapped image5d archives.

Formats: OME-TIFF, Zeiss CZI (zstd-compressed and per-plane JPEG), Leica
LIF (with Length calibration), Nikon ND2 (chunk map and the legacy JP2
container), Olympus OIB (OLE2 compound file) and OIF (INI + plane
directory), Imaris IMS (HDF5 chunked+gzip, default and libhdf5-'latest'
profiles). Readers are pure Python except where the format needs a
codec: Zstd, JPEG, JPEG 2000 and latest-HDF5 bind the system libzstd,
libjpeg, libopenjp2 and libhdf5 through ctypes, and a format whose
library is absent raises by name.

Run: python examples/torch/demo_formats.py [out_dir] [--formats NAME ...]
[--device cpu] [--no-figures] (every format by default). The work is the
host's; ``--device`` is checked as the other demos check it (the card by
default, raising without one) and the demo makes no figure.
"""

import argparse
import os
import pathlib
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

#: every format, and the system library each needs beyond Python
FORMATS = {"OME-TIFF": None, "CZI-zstd": "libzstd", "LIF": None,
           "ND2": None, "OIB": None, "OIF": None, "IMS": None,
           "CZI-jpeg": "libjpeg", "IMS-lat": "libhdf5",
           "ND2-leg": "libopenjp2"}
OME = (
    '<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.'
    'org/Schemas/OME/2016-06"><Image><Pixels DimensionOrder='
    '"XYZCT" Type="uint16" SizeX="24" SizeY="24" SizeZ="4" '
    'SizeC="1" SizeT="1" PhysicalSizeX="0.5" PhysicalSizeY="0.5" '
    'PhysicalSizeZ="2.0"><TiffData/></Pixels></Image></OME>')


def write_format(name, out, vol):
    """Write ``vol`` as format ``name`` under ``out``; returns the path,
    the volume the import must give back and its tolerance."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import czi_lif, tiff

    if name == "OME-TIFF":
        path = str(out / "demo.ome.tif")
        tiff.write_tiff(path, vol, description=OME)
    elif name == "CZI-zstd":
        path = str(out / "demo.czi")
        czi_lif.write_czi(path, vol, resolutions=(2.0, 0.5, 0.5),
                          compression="zstd0")
    elif name == "LIF":
        path = str(out / "demo.lif")
        czi_lif.write_lif(path, vol, resolutions=(2.0, 0.5, 0.5))
    elif name == "ND2":
        path = str(out / "demo.nd2")
        pathlib.Path(path).write_bytes(testing.nd2_bytes(
            list(vol), testing.nd2_attributes(24, 24, n_seq=4)))
    elif name == "OIB":
        # OLE2 compound file of per-plane TIFF streams
        path = str(out / "demo.oib")
        pathlib.Path(path).write_bytes(testing.cfbf_bytes({
            f"s_C001Z{z + 1:03d}.tif": testing.tiff_bytes(vol[z])
            for z in range(vol.shape[0])}))
    elif name == "OIF":
        # UTF-16 INI main file + .files plane directory
        path = str(out / "demo.oif")
        fdir = pathlib.Path(path + ".files")
        fdir.mkdir(exist_ok=True)
        for z in range(vol.shape[0]):
            tiff.write_tiff(str(fdir / f"s_C001Z{z + 1:03d}.tif"),
                            vol[z][None])
        ini = ("[Reference Image Parameter]\nWidthConvertValue=0.5\n"
               '[Axis 3 Parameters Common]\nAxisCode="Z"\nInterval=2.0\n')
        pathlib.Path(path).write_bytes(
            b"\xff\xfe" + ini.encode("utf-16-le"))
    elif name == "IMS":
        path = str(out / "img.ims")
        pathlib.Path(path).write_bytes(testing.ims_bytes([vol]))
    elif name == "CZI-jpeg":
        plane = np.full((1, 24, 24), 30, np.uint8)
        plane[0, 6:18, 6:18] = 200
        path = str(out / "demo_jpeg.czi")
        czi_lif.write_czi(path, plane, resolutions=(2.0, 0.5, 0.5),
                          compression="jpeg")
        return path, plane, 2
    elif name == "IMS-lat":
        path = testing.write_ims(str(out / "demo_latest.ims"), [vol],
                                 vol.shape, libver="latest",
                                 chunks=(2, 24, 24), gzip=4, shuffle=True)
    elif name == "ND2-leg":
        from magellanmapper_torch.io import jp2k, nd2
        payload = (nd2.JP2_SIGNATURE + testing.JP2_FTYP
                   + testing.jp2_header(24, 24))
        for z in range(vol.shape[0]):
            payload += testing.jp2_box(
                b"jp2c", jp2k.encode(vol[z], num_resolutions=4))
        path = str(out / "demo_legacy.nd2")
        pathlib.Path(path).write_bytes(payload)
    else:
        raise ValueError(f"unknown format {name}; options: {list(FORMATS)}")
    return path, vol, 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("out_dir", nargs="?", default="demo_out/torch/formats")
    parser.add_argument("--formats", nargs="+", choices=list(FORMATS),
                        default=list(FORMATS))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    out = pathlib.Path(args.out_dir)
    from magellanmapper_torch import device as device_mod
    from magellanmapper_torch.io import cli, np_io

    device_mod.resolve(args.device)

    rng = np.random.default_rng(0)
    vol = (rng.random((4, 24, 24)) * 4000).astype(np.uint16)

    print(f"{'format':9s} {'file':16s} {'image5d':18s} match")
    matches = {}
    for name in args.formats:
        path, want, atol = write_format(name, out, vol)
        prefix = str(out / ("imp_" + name.lower().replace("-", "")))
        cli.main(["--img", path, "--proc", "import_only",
                  "--prefix", prefix])
        img5d = np_io.read_file(prefix)
        got = np.asarray(img5d.img[0])
        if got.ndim == 4:
            got = got[..., 0]
        matches[name] = got.shape == want.shape and bool(
            (np.abs(got.astype(np.int64)
                    - want.astype(np.int64)) <= atol).all())
        print(f"{name:9s} {os.path.basename(path):16s} "
              f"{str(img5d.img.shape):18s} {matches[name]}")
    ok = all(matches.values())
    print("ALL FORMATS ROUND-TRIP" if ok else "MISMATCH", flush=True)
    return {"ok": ok, "matches": matches}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
