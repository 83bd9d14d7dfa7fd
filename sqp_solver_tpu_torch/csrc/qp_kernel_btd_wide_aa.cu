// The Anderson-accelerated instantiation of the wide structured kernel (K6,
// K7 at internal blocks past 32) and its entry point
// (qp_btd_wide_launch_aa_nnz): qp_kernel_btd_wide.cu compiled with
// QP_KERNEL_BTD_WIDE_AA_UNIT, which leaves out the kernel without
// Anderson and its entry points.  A unit of its own, so that nvcc builds it
// in a process of its own beside the others.

#define QP_KERNEL_BTD_WIDE_AA_UNIT
#define ADMM_PHASE_READER admm_phase_clocks_aa  // the phase-clock builds' reader
#include "qp_kernel_btd_wide.cu"
