"""The work count of the configurations whose reference is
``reference/poisson_tn_mh.py`` (Poisson, truncated-normal prior, exact MH):
``benchmark/workcount.py``, with its peaks. A configuration's count is
found by its reference's name; a model without a file here has no count,
and the metrics that rest on one read nothing."""

from benchmark.workcount import kernel_bound_s, step_bound_s  # noqa: F401
