/* OptTpu.h — C API for the opt_tpu nonlinear least squares
 * framework.
 *
 * Mirrors the reference Opt C API one-for-one
 * (reference: API/release/include/Opt.h:10-71) so C/C++ clients structured
 * for Opt port directly. Where the reference embeds a LuaJIT/Terra VM in
 * libOpt.a (API/src/createwrapper.t:124-211), libopttpu embeds CPython and
 * dispatches to the opt_tpu package; energy specs are Python files instead
 * of Terra files.
 *
 * Data binding is positional, matching the reference convention
 * (util.t:664-692, examples/shared/NamedParameters.h:34-47):
 *   dims[]: one uint32 per Dim in first-use order.
 *   data[]: per image (decl order) a float* of row-major [*dims, channels];
 *           per graph: int32* edge count then one int32* per vertex slot;
 *           per scalar Param: float*.
 * Unknown images are written back into the caller's buffers when the solve
 * finishes (the reference updates the caller's GPU buffers in place).
 */
#ifndef OPT_TPU_H
#define OPT_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct Opt_State Opt_State;
typedef struct Opt_Problem Opt_Problem;
typedef struct Opt_Plan Opt_Plan;

/* reference: Opt_InitializationParameters, Opt.h:10-30 */
typedef struct {
    int doublePrecision;
    int verbosityLevel;
    int collectPerKernelTimingInfo;
    int threadsPerBlock; /* accepted for compatibility; no meaning here */
} Opt_InitializationParameters;

Opt_State* Opt_NewState(Opt_InitializationParameters params);
void Opt_FreeState(Opt_State* state);

/* energySpecFile: path to a Python file defining the energy (a function
 * named `spec`, or a single public function). solverKind: "gaussNewtonGPU"
 * or "LMGPU" (o.t:122). */
Opt_Problem* Opt_ProblemDefine(Opt_State* state, const char* energySpecFile,
                               const char* solverKind);
void Opt_ProblemDelete(Opt_State* state, Opt_Problem* problem);

Opt_Plan* Opt_ProblemPlan(Opt_State* state, Opt_Problem* problem,
                          const uint32_t* dims, uint32_t numDims);
void Opt_PlanFree(Opt_State* state, Opt_Plan* plan);

void Opt_SetSolverParameter(Opt_State* state, Opt_Plan* plan,
                            const char* name, double value);

void Opt_ProblemInit(Opt_State* state, Opt_Plan* plan, void** data,
                     uint32_t numData);
int Opt_ProblemStep(Opt_State* state, Opt_Plan* plan);
void Opt_ProblemSolve(Opt_State* state, Opt_Plan* plan, void** data,
                      uint32_t numData);
double Opt_ProblemCurrentCost(Opt_State* state, Opt_Plan* plan);

/* returns a static string describing the last error, or NULL */
const char* Opt_LastError(void);

#ifdef __cplusplus
}
#endif

#endif /* OPT_TPU_H */
