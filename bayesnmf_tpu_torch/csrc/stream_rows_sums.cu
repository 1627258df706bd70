// The sums-only entry points of the P- and A-column kernels' row form (from
// 192 rows on), built as their own translation unit beside stream_rows.cu
// (the row form's column updates) and stream_sweeps.cu, whose kernels and
// launchers they share; see stream_sweeps.cu for the kernels, what they
// replace, what bounds them and their design.
#define STREAM_ROWS_SUMS_ONLY
#include "stream_sweeps.cu"
