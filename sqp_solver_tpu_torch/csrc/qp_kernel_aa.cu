// The Anderson-accelerated instantiations of K1 and K3 (both layouts) and
// their entry points (sqp_step_launch_aa, qp_solve_launch_aa,
// admm_aa_floats): qp_kernel.cu compiled with QP_KERNEL_AA_UNIT, which
// leaves out every kernel without Anderson and its entry points.  A unit of
// its own, so that nvcc builds these instantiations in a process of their
// own, beside qp_kernel.cu; the kernels without Anderson stay as they were.

#define QP_KERNEL_AA_UNIT
#define ADMM_PHASE_READER admm_phase_clocks_aa  // the phase-clock builds' reader
#include "qp_kernel.cu"
