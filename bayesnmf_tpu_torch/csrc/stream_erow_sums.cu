// The E row's sums-only entry point, built as its own translation unit
// beside stream_sweeps.cu, whose kernels and launchers it shares; see
// stream_sweeps.cu for the kernels, what they replace, what bounds them and
// their design.
#define STREAM_EROW_SUMS_ONLY
#include "stream_sweeps.cu"
