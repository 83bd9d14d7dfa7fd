// The Anderson instantiations of the structured kernel (K6, K7) whose step
// solves the chunk's system off the Gram area past memory 32 (a solve area
// by columns, in shared memory or the workspace, solved by the whole
// block: qp_btd_kernel_aas) and their entry points (qp_btd_launch_aas,
// which qp_btd_launch_aa calls where btd_aa_plan puts the system there):
// qp_kernel_btd.cu compiled with QP_KERNEL_BTD_AA_UNIT and
// QP_KERNEL_BTD_AAS_UNIT.  A unit of its own, so that nvcc builds these
// instantiations in a process of their own beside qp_kernel_btd_aa.cu, the
// library's longest, whose kernels stay as they were.

#define QP_KERNEL_BTD_AA_UNIT
#define QP_KERNEL_BTD_AAS_UNIT
#define ADMM_PHASE_READER admm_phase_clocks_aas  // the phase-clock builds' reader
#include "qp_kernel_btd.cu"
