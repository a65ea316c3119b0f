"""Results aggregation (counterpart of :mod:`auvtpu.cli.analyze`, the
rebuild of performance_results.ipynb cells 7-40).

Reads a results CSV in the reference 9-column schema (optionally with the
Region column this framework adds) and writes:
- grid_A_runtimes_averaged.csv: mean time per (BatchSize, Machine, Method)
  for GridType A rows, in the reference's wide layout;
- <Region>_runtimes_errors.csv: per-region mean time/MAE/RMSE/max for
  GridType B rows.

The notebook attributed regions by manual row ranges and called it out as
'very bad' (performance_results cell 14); rows carrying a Region column are
grouped properly, and region-less rows land in 'unattributed'.  Needs
pandas, imported when a function runs (the machine with the card may not
have it).

Run: ``python3 -m auvtpu_torch.cli.analyze --results results_local/TestingResults1.csv``
"""

from __future__ import annotations

import argparse
import os

from ..config import RESULTS_SCHEMA


def load_results(path: str):
    import pandas as pd

    df = pd.read_csv(path)
    missing = set(RESULTS_SCHEMA) - set(df.columns)
    if missing:
        raise SystemExit(f"{path} is missing schema columns: {sorted(missing)}")
    if "Region" not in df.columns:
        df["Region"] = "unattributed"
    df["Region"] = df["Region"].fillna("unattributed")
    return df


def grid_a_table(df):
    import pandas as pd

    a = df[df["GridType"] == "A"]
    if a.empty:
        return pd.DataFrame()
    t = a.pivot_table(index="BatchSize", columns=["Machine", "InterpolationType"],
                      values="Time", aggfunc="mean")
    t.columns = [f"{m} {i}" for m, i in t.columns]
    return t.sort_index()


def grid_b_tables(df) -> dict:
    b = df[df["GridType"] == "B"]
    out = {}
    for region, sub in b.groupby("Region"):
        t = sub.pivot_table(
            index=["RemovalFraction", "BatchSize"],
            columns=["Machine", "InterpolationType"],
            values=["Time", "MAE", "RMSE", "Max Error"],
            aggfunc="mean",
        )
        t.columns = [f"{v} {m} {i}" for v, m, i in t.columns]
        out[str(region)] = t
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--out-dir", default="results_local")
    args = p.parse_args(argv)

    df = load_results(args.results)
    os.makedirs(args.out_dir, exist_ok=True)

    a = grid_a_table(df)
    if not a.empty:
        path = os.path.join(args.out_dir, "grid_A_runtimes_averaged.csv")
        a.to_csv(path)
        print(f"wrote {path} ({len(a)} batch sizes)")

    for region, t in grid_b_tables(df).items():
        path = os.path.join(args.out_dir, f"{region}_runtimes_errors.csv")
        t.to_csv(path)
        print(f"wrote {path} ({len(t)} configs)")


if __name__ == "__main__":
    main()
