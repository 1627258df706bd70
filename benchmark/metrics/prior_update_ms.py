"""Milliseconds of the streaming step's prior update: the exact Mu/Sigmasq
update (``models/updates.py`` ``sample_prior_params``) and the rank draw
(``sample_R``), CUDA events around repeated calls of the calls captured in
the window."""


def read(run):
    return run.kernel_ms.get("prior_update")
