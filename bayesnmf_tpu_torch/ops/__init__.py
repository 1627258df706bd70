"""Tensor ops and the hand-written CUDA kernels of the port."""

#: The envelope of shapes every kernel takes on the card: K rows up to the
#: SBS-1536 catalogue (SigProfilerMatrixGenerator's largest; DBS-78, ID-83,
#: SBS-96/192/288/384 lie inside) and N components (a rank, or the largest
#: of a rank list) up to 128. G and the chain count are bounded by the
#: card's memory only.
MAX_K = 1536
MAX_N = 128


def check_envelope(fn: str, K: int, N: int):
    """Raise ValueError, before any launch, for a shape beyond the
    envelope."""
    if not (1 <= K <= MAX_K and 1 <= N <= MAX_N):
        raise ValueError(
            f"{fn}: the kernels take K <= {MAX_K} rows and N <= {MAX_N} "
            f"components on the card; got K = {K}, N = {N}")
