// The Anderson-accelerated instantiations of the structured kernel (K6, K7)
// and their entry point (qp_btd_launch_aa): qp_kernel_btd.cu compiled with
// QP_KERNEL_BTD_AA_UNIT, which leaves out the kernel without Anderson and
// its entry points.  A unit of its own, so that nvcc builds these
// instantiations in a process of their own, beside qp_kernel_btd.cu; the
// kernel without Anderson stays as it was.

#define QP_KERNEL_BTD_AA_UNIT
#define ADMM_PHASE_READER admm_phase_clocks_aa  // the phase-clock builds' reader
#include "qp_kernel_btd.cu"
