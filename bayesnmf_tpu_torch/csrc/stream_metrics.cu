// The metrics row's entry points (the whole row and its four data sums),
// built as their own translation unit beside stream_sweeps.cu, whose
// kernels and launchers they share; see stream_sweeps.cu for the kernels,
// what they replace, what bounds them and their design.
#define STREAM_METRICS_ONLY
#include "stream_sweeps.cu"
