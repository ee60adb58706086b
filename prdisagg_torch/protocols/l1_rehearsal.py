"""A rehearsal of the L1 file contracts, raw files to the parity gate, on
the port's command line (the JAX package's ``scripts/l1_rehearsal.py``).

Writes a small synthetic corpus of raw radar files to disk (per-day
directories of 5-minute uint8 reflectivity GeoTIFFs, written with
Pillow), then drives the real-data sequence through
``python -m prdisagg_torch.cli``, each stage a subprocess on the files the
one before left on disk:

    convert-tiffs    raw GeoTIFFs     -> smhi_radar_YYYYMMDD.nc
    reformat-nc      per-day .nc      -> {start}-{end}_tres1.npy (+ _doy)
    compute-indices  tensor           -> data/valid_indices_smhi_radar_{params}.pkl
    train            tensor + indices -> gen_*.h5 (or .npz) and hist.csv
    evaluate         weights + tensor -> the reference's artifact names
    parity-report    ours vs --reference -> parity_report.json

    python -m prdisagg_torch.protocols.l1_rehearsal [WORKDIR] [--days 4]
        [--size 48] [--epochs 1] [--steps-per-epoch 20] [--device cuda]
        [--export-format h5|npz|both] [--no-plots] [--reference DIR]

Without ``--reference`` (the reference's published
plots_generated_wgancp_pixelnorm directory) the parity stage is left out,
as the JAX driver leaves it out where those artifacts are not mounted; the
parity report reads the evaluation's figure CSVs, so it needs plots.
Exit 0 and a JSON summary line (also ``WORKDIR/l1_rehearsal_summary.json``)
on success.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import subprocess
import sys

import numpy as np

from prdisagg_torch.protocols import add_run_args, export_paths

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_raw_corpus(raw_dir: str, dates, size: int, seed: int = 0) -> int:
    """Per-day directories of 288 five-minute uint8 reflectivity GeoTIFFs
    in the SMHI raw encoding (convert_smhi_radardata.py:39-43): 255 is
    missing, dBZ = x * 0.4 - 30.  Two drifting rain blobs under an
    afternoon envelope, so whole-day sums give valid boxes; the missing
    data is a border, as in real scans (random speckle would poison a
    quarter of the daily pixels under NaN-propagating sums)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    missing = np.zeros((size, size), bool)
    missing[:2, :] = True
    n_files = 0
    for date in dates:
        ddir = os.path.join(raw_dir, date)
        os.makedirs(ddir, exist_ok=True)
        centres = [rng.rand(2) * size for _ in range(2)]
        for step in range(288):
            hour = step / 12.0
            envelope = 0.35 + 0.65 * np.exp(-((hour - 15.0) ** 2) / 18.0)
            dbz = rng.randn(size, size) * 1.5
            for c in centres:
                c += rng.randn(2) * 0.8
                c %= size
                d2 = ((yy - c[0]) % size) ** 2 + ((xx - c[1]) % size) ** 2
                # about 45 dBZ (raw 187) in the blob's core
                dbz += 45.0 * envelope * np.exp(-d2 / (2 * (size / 6) ** 2))
            raw = np.clip((dbz + 30.0) / 0.4, 0, 254).astype(np.uint8)
            raw[missing] = 255
            Image.fromarray(raw, mode="L").save(
                os.path.join(ddir, f"radar_{date}_{step:03d}.tif"))
            n_files += 1
    return n_files


def run_cli(workdir: str, *cli_args, timeout: float = 1500) -> str:
    """One CLI stage in a fresh process whose working directory is
    `workdir`, so that the contract's file names resolve there, as in a
    real run; the package comes from the repository's path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "prdisagg_torch.cli", *cli_args]
    print(f"\n$ {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, cwd=workdir, env=env, timeout=timeout,
                          capture_output=True, text=True)
    sys.stdout.write(proc.stdout[-3000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(
            f"stage {' '.join(cli_args[:1])} failed rc={proc.returncode}")
    return proc.stdout


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.l1_rehearsal",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join("artifacts", "l1_rehearsal_torch"))
    ap.add_argument("--days", type=int, default=4)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--reference", default=None,
                    help="the reference's published plots directory for "
                         "parity-report")
    add_run_args(ap, preset=False)
    return ap.parse_args(argv)


def run(args) -> dict:
    """The chain; returns the summary it writes."""
    from prdisagg_torch.protocols import refuse_missing

    refuse_missing(args)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    dev = ["--device", args.device]
    dates = [f"200901{d + 1:02d}" for d in range(args.days)]
    start, end = dates[0], dates[-1]
    span = ["--startdate", start, "--enddate", end]
    summary = {"workdir": wd, "dates": [start, end]}

    # stage 0: the raw corpus on disk
    raw_dir = os.path.join(wd, "raw_tiffs")
    summary["raw_files"] = write_raw_corpus(raw_dir, dates, args.size)
    print(f"[0] wrote {summary['raw_files']} raw GeoTIFFs under {raw_dir}")

    # stage 1: GeoTIFFs -> per-day mm/5min netCDF
    nc_dir = os.path.join(wd, "netcdf")
    run_cli(wd, "convert-tiffs", "--tiff-dir", raw_dir, "--out-dir", nc_dir)
    ncs = sorted(glob.glob(os.path.join(nc_dir, "smhi_radar_*.nc")))
    if len(ncs) != args.days:
        raise AssertionError(ncs)
    summary["nc_files"] = [os.path.basename(p) for p in ncs]

    # stage 2: .nc -> {start}-{end}_tres1.npy (reformat_data.py:86-91)
    run_cli(wd, "reformat-nc", "--nc-dir", nc_dir, *span)
    tensor_path = os.path.join(wd, f"{start}-{end}_tres1.npy")
    for path in (tensor_path, tensor_path.replace(".npy", ".npz")):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    summary["tensor"] = os.path.basename(tensor_path)
    summary["tensor_shape"] = list(np.load(tensor_path, mmap_mode="r").shape)
    # the doy sidecar (reformat_data_make_timelist.py) comes with it
    doy_path = os.path.join(wd, f"{start}-{end}_tres1_doy.npy")
    doy = np.load(doy_path)
    if len(doy) != args.days or doy[0] != 1.0:  # Jan 1
        raise AssertionError(doy)
    summary["doy_sidecar"] = os.path.basename(doy_path)

    # stage 3: valid indices (compute_valid_indices.py:91-99)
    run_cli(wd, "compute-indices", "--data", tensor_path, *span, *dev)
    pkls = glob.glob(os.path.join(
        wd, "data", f"valid_indices_smhi_radar_{start}-{end}-*.pkl"))
    if len(pkls) != 1:
        raise AssertionError(pkls)
    with open(pkls[0], "rb") as f:
        n_idx = len(pickle.load(f))
    if n_idx == 0:
        raise AssertionError("no valid samples in the synthetic corpus")
    summary["indices"] = os.path.basename(pkls[0])
    summary["n_valid_samples"] = n_idx

    # stage 4: train from the files; the tiny preset, because this drills
    # the file contracts, not the model
    train_dir = os.path.join(wd, "train")
    run_cli(wd, "train", "--data", tensor_path, "--indices", pkls[0], *span,
            "--schedule", f"{args.epochs}:16", "--n-disc", "1",
            "--steps-per-epoch", str(args.steps_per_epoch),
            "--model-preset", "tiny", "--f32-parity",
            "--export-format", args.export_format,
            "--plot-every-epochs", "0" if args.no_plots else "1",
            "--workdir", train_dir, "--name", "l1rehearsal", *dev)
    exports = export_paths(os.path.join(train_dir, "trained_models",
                                        "l1rehearsal"), args.export_format)
    if not exports:
        raise FileNotFoundError("train produced no generator exports")
    summary["weights"] = os.path.basename(exports[-1])

    # stage 5: evaluate, with the reference's artifact names
    eval_dir = os.path.join(wd, "eval")
    run_cli(wd, "evaluate", "--weights", exports[-1], "--data", tensor_path,
            "--indices", pkls[0], *span, "--workdir", eval_dir, "--smoke",
            "--epoch", str(args.epochs), *dev,
            *(["--no-plots"] if args.no_plots else []))
    plotdirs = glob.glob(os.path.join(eval_dir, "plots_generated_*"))
    if not plotdirs:
        raise FileNotFoundError(os.listdir(eval_dir))
    summary["eval_plots"] = len(glob.glob(os.path.join(plotdirs[0], "*")))

    # stage 6: the parity gate against the published artifacts (a
    # one-epoch model may FAIL it: producing the report is the contract)
    report_path = os.path.join(wd, "parity_report.json")
    if args.reference:
        run_cli(wd, "parity-report", "--ours", plotdirs[0],
                "--reference", os.path.abspath(args.reference),
                "--out", report_path)
        with open(report_path) as f:
            rep = json.load(f)
        summary["parity_report"] = {
            "passes": rep["passes"],
            "ks_p_match": rep["ks_population"]["p_match"],
            "cycle_correlation": rep["daily_cycle"]["correlation"],
        }
    else:
        summary["parity_report"] = "reference artifacts not given"

    summary["ok"] = True
    with open(os.path.join(wd, "l1_rehearsal_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("\n" + json.dumps(summary))
    return summary


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
