// The Anderson instantiations of the wide structured kernel (K6, K7 at
// internal blocks past 32, both routes) whose step solves the chunk's
// system off the Gram area past memory 32 (a solve area by columns, in
// shared memory or the workspace, solved by the whole block:
// qp_btd_wide_kernel_aas, qp_btd_xwide_kernel_aas) and their entry point
// (qp_btd_wide_launch_aas_nnz, which qp_btd_wide_launch_aa_nnz calls where
// wide_aa_plan puts the system there): qp_kernel_btd_wide.cu compiled with
// QP_KERNEL_BTD_WIDE_AA_UNIT and QP_KERNEL_BTD_WIDE_AAS_UNIT, a unit of its
// own beside qp_kernel_btd_wide_aa.cu, whose kernels stay as they were.

#define QP_KERNEL_BTD_WIDE_AA_UNIT
#define QP_KERNEL_BTD_WIDE_AAS_UNIT
#define ADMM_PHASE_READER admm_phase_clocks_aas  // the phase-clock builds' reader
#include "qp_kernel_btd_wide.cu"
