// The column updates of the P- and A-column kernels' row form (from 192
// rows on, picked by ops/stream_sweeps.py::col_rows_form), built as their
// own translation unit beside stream_rows_sums.cu (the row form's sums-only
// entry points) and stream_sweeps.cu, whose kernels and launchers they
// share; see stream_sweeps.cu for the kernels, what they replace, what
// bounds them and their design.
#define STREAM_ROWS_ONLY
#include "stream_sweeps.cu"
