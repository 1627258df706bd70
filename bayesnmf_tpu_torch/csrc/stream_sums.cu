// The sums-only entry points of the streaming kernels (the four bodies of
// `_run`, `acol_delta`, `chain_metrics`), the special functions' check and
// the exact hyper-update, built as their own translation unit beside
// stream_sweeps.cu, whose kernels and launchers they share; see
// stream_sweeps.cu for the kernels, what they replace, what bounds them and
// their design.
#define STREAM_SUMS_ONLY
#include "stream_sweeps.cu"
