"""Export the CLIP caption-embedding table that the shipped configuration
reads (``text_encoder.table_path: ./data/text_embeddings.npz``), from a local
Hugging Face CLIP directory through the port's ``ClipTextEncoder``:

    python -m afford_motion_torch.tools.export_text_embeddings --data_dir ./data \\
        --out ./data/text_embeddings.npz --weights_dir ./data/clip --max_length 20

It runs on the card unless ``--device cpu`` is given. The table holds every
caption the datasets can produce, the empty string (classifier-free
guidance's null text) included: the ``utterance`` column of each set's
``contact_motion/anno.csv`` (split on ``$$``) and of ``custom/anno.csv``,
and the captions of ``H3D/texts/*.txt``, sorted.

Truncation follows the JAX package's ``ClipTextEncoder`` (and so the live
encoder): ``max_length + 2`` tokens with the end-of-text token kept, then
padding to 77. The root ``tools/export_clip_embeddings.py`` zeroes the ids
past ``max_length + 2`` instead, which drops the end-of-text token of a
longer caption; its tables differ from the live encoder's there.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional

import numpy as np
import pandas as pd

from ..models.text import ClipTextEncoder
from ..utils.device import resolve_device


def _utterances(path: str, split: bool) -> List[str]:
    out = []
    for u in pd.read_csv(path).get("utterance", []):
        if isinstance(u, str) and u:
            out.extend(u.split("$$") if split else [u])
    return out


def collect_captions(data_dir: str) -> List[str]:
    """Every caption under ``data_dir`` and ``""``, sorted."""
    captions = {""}
    for anno in glob.glob(os.path.join(data_dir, "*", "contact_motion", "anno.csv")):
        captions.update(_utterances(anno, split=True))
    custom = os.path.join(data_dir, "custom", "anno.csv")
    if os.path.exists(custom):
        captions.update(_utterances(custom, split=False))
    for txt in glob.glob(os.path.join(data_dir, "H3D", "texts", "*.txt")):
        with open(txt, encoding="utf-8") as f:
            for line in f:
                cap = line.split("#")[0].strip()
                if cap:
                    captions.add(cap)
    return sorted(captions)


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--out", default="./data/text_embeddings.npz")
    p.add_argument("--weights_dir", default="./data/clip")
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    captions = collect_captions(args.data_dir)
    print(f"{len(captions)} unique captions")
    encoder = ClipTextEncoder(args.weights_dir, max_length=args.max_length,
                              device=resolve_device({}, args.device))
    emb = encoder.encode(captions)
    np.savez(args.out, texts=np.array(captions, dtype=str), embeddings=emb)
    print(f"wrote {args.out}: {emb.shape}")
    return args.out


if __name__ == "__main__":
    main()
