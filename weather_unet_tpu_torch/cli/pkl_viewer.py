"""Dataset pickle inspector -- the port of
``weather_unet_tpu/cli/pkl_viewer.py`` (the reference's
``ipynb/pkl_viewer.ipynb``): type, shape and columns, head, and the
mode / class counts of a frame; keys, lengths and heads of a split dict.

    python -m weather_unet_tpu_torch.cli.pkl_viewer split.pkl --head 3
    python -m weather_unet_tpu_torch.cli.pkl_viewer frame.pkl --column mode
"""

from __future__ import annotations

import argparse
import pickle


def build_parser():
    p = argparse.ArgumentParser(description="inspect dataset pickles")
    p.add_argument("pkl", type=str)
    p.add_argument("--head", type=int, default=5)
    p.add_argument("--column", type=str, default=None,
                   help="show value counts of this column")
    return p


def _describe_frame(df, head: int, column) -> None:
    print(f"shape: {df.shape}")
    print(f"columns: {list(df.columns)}")
    print(df.head(head))
    for col in ([column] if column else
                [c for c in ("mode", "condition2", "w_condition") if c in df]):
        print(f"\n{col} value counts:")
        print(df[col].value_counts())


def main(argv=None):
    args = build_parser().parse_args(argv)
    # a pickle runs code as it loads: open only files you trust
    with open(args.pkl, "rb") as f:
        obj = pickle.load(f)
    print(f"type: {type(obj).__name__}")
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(obj, pd.DataFrame):
        _describe_frame(obj, args.head, args.column)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            desc = f"len {len(v)}" if hasattr(v, "__len__") else repr(v)[:60]
            print(f"  {k}: {type(v).__name__} ({desc})")
            if isinstance(v, (list, tuple)) and v:
                print(f"    head: {v[:args.head]}")
    elif isinstance(obj, (list, tuple)):
        print(f"len: {len(obj)}")
        print(f"head: {obj[:args.head]}")
    else:
        print(repr(obj)[:500])


if __name__ == "__main__":
    main()
