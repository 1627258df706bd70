"""COSMIC v3.3.1 SBS reference signatures (get_cosmic, get_cosmic_colors;
helpers.R:166-206).

The CSV is the public COSMIC v3.3.1 GRCh37 SBS matrix (96 trinucleotide
mutation types x 79 signatures), carried under bayesnmf_tpu_torch/data/.
"""

from __future__ import annotations

import os

import pandas as pd

COSMIC_CSV = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "COSMIC_v3.3.1_SBS_GRCh37.csv")


def get_cosmic() -> pd.DataFrame:
    """The COSMIC v3.3.1 SBS GRCh37 signature matrix (96 x 79)."""
    return pd.read_csv(COSMIC_CSV, index_col=0)


def get_cosmic_colors() -> dict:
    """The 6 substitution-class colours of COSMIC signature plots."""
    return {
        "C>A": (8 / 255, 181 / 255, 236 / 255),
        "C>G": (0.0, 0.0, 0.0),
        "C>T": (225 / 255, 37 / 255, 33 / 255),
        "T>A": (198 / 255, 193 / 255, 195 / 255),
        "T>C": (153 / 255, 200 / 255, 87 / 255),
        "T>G": (233 / 255, 190 / 255, 189 / 255),
    }
