// K5's pow, compiled as PyTorch compiles its own CUDA kernels.
//
// The plain step raises to a power with torch.pow (the custom f(r_g)
// mean-free-path law, ops/step.py), whose CUDA kernel calls the CUDA
// libm's pow in a build that lets the compiler contract a product and a
// sum into one fused multiply-add.  K5 (helix_step.cu) is built with
// -fmad=false, so that its own arithmetic rounds every product as the
// plain step's separate torch kernels do; inside libm's pow that setting
// gives another result on a few inputs in a million.  This unit is built
// with -fmad=true as relocatable device code and linked into K5's
// library (ops/build.py UNITS), so that K5's pow is torch's, bit for bit.

#include <cuda_runtime.h>
#include <math.h>

__device__ double helix_pow(double a, double b) { return pow(a, b); }

__device__ float helix_powf(float a, float b) { return powf(a, b); }
