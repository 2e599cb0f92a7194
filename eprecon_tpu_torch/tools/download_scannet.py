"""ScanNet dataset downloader (own copy of
eprecon_tpu/tools/download_scannet.py).

Reference: datasets/scannet/download_scannet.py — fetches .sens / label
archives per scene from the official ScanNet server after terms-of-use
agreement. Same protocol; trimmed to the file types the port consumes
(sens_reader, load_scannet_labels). Importing the module opens nothing.

CLI (asks to confirm the terms of use first):
  python -m eprecon_tpu_torch.tools.download_scannet -o DIR --id scene0000_00
"""
from __future__ import annotations

import argparse
import os
import urllib.request

BASE_URL = "http://kaldir.vc.in.tum.de/scannet/"
TOS_URL = BASE_URL + "ScanNet_TOS.pdf"
RELEASE = "v2/scans"
RELEASE_TASKS = "v2/tasks"
FILE_TYPES = [".sens", "_vh_clean_2.ply", "_vh_clean_2.0.010000.segs.json",
              ".aggregation.json", "_vh_clean_2.labels.ply"]


def download_file(url: str, out_file: str):
    if os.path.isfile(out_file):
        return
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    tmp = out_file + ".tmp"
    urllib.request.urlretrieve(url, tmp)
    os.rename(tmp, out_file)


def download_scan(scan_id: str, out_dir: str, file_types=FILE_TYPES):
    print(f"downloading {scan_id} ...")
    for ft in file_types:
        url = f"{BASE_URL}{RELEASE}/{scan_id}/{scan_id}{ft}"
        download_file(url, os.path.join(out_dir, scan_id, f"{scan_id}{ft}"))


def download_label_map(out_dir: str):
    download_file(f"{BASE_URL}{RELEASE_TASKS}/scannetv2-labels.combined.tsv",
                  os.path.join(out_dir, "scannetv2-labels.combined.tsv"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Downloads ScanNet public data release (requires accepted "
                    "terms of use: " + TOS_URL)
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("--id", help="single scan id, e.g. scene0000_00")
    ap.add_argument("--scans_file", help="file with one scan id per line")
    ap.add_argument("--label_map", action="store_true")
    args = ap.parse_args(argv)

    key = input("Press Enter to confirm you have agreed to the ScanNet terms "
                "of use, or Ctrl-C to abort: ")
    del key
    if args.label_map:
        download_label_map(args.out_dir)
    ids = []
    if args.id:
        ids = [args.id]
    elif args.scans_file:
        with open(args.scans_file) as f:
            ids = [line.strip() for line in f if line.strip()]
    for sid in ids:
        download_scan(sid, os.path.join(args.out_dir, "scans"))


if __name__ == "__main__":
    main()
