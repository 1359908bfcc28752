/* C interface to the spllt_tpu sparse Cholesky solver.
 *
 * Analogue of the reference's C interface
 * (/root/reference/include/spllt_iface.h:14-47): opaque handles over the
 * analyse / factor / solve phases on CSC lower-triangle input.  The
 * implementation (native/capi.cpp) embeds CPython and drives the JAX
 * framework; link with libspllt_tpu_c.so.
 *
 * Index arrays are int64_t, 0-based, CSC lower triangle including the
 * diagonal.  All functions return 0 on success; negative on error
 * (-1 = matrix not positive definite, -2 = phase order violated,
 *  -3 = internal error, see stderr).
 */
#ifndef SPLLT_TPU_H
#define SPLLT_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  int nb;             /* factorization tile size (default 256)       */
  int nemin;          /* supernode amalgamation threshold (32)       */
  int refine;         /* iterative-refinement steps in solve (2)     */
  const char *ordering;   /* "amd" | "nd" | "rcm" | "natural" (amd)  */
  const char *schedule;   /* "scan" | "unrolled" (scan)              */
  const char *precision;  /* "highest" | "default" (highest)         */
} spllt_tpu_options_t;

#define SPLLT_TPU_OPTIONS_DEFAULT \
  { 256, 32, 2, "amd", "scan", "highest" }

typedef struct {
  int64_t num_factor;   /* nnz(L) predicted by analyse   */
  double num_flops;     /* factorization flops           */
  int64_t num_nodes;    /* supernodes                    */
} spllt_tpu_inform_t;

/* Initialise the embedded runtime (idempotent; called implicitly). */
int spllt_tpu_init(void);

/* Symbolic analysis.  ptr[n+1], row[ptr[n]] describe the CSC lower
 * triangle.  On success *handle receives an opaque handle. */
int spllt_tpu_analyse(void **handle, const spllt_tpu_options_t *options,
                      int64_t n, const int64_t *ptr, const int64_t *row,
                      spllt_tpu_inform_t *inform);

/* Numeric factorization with values matching the analysed pattern.
 * Repeated calls refactorize (akeep-reuse workflow). */
int spllt_tpu_factor(void *handle, const double *val);

/* Solve: x [n*nrhs], column-major, rhs in / solution out.
 * job: 0 = A x = b, 1 = forward only, 2 = backward only. */
int spllt_tpu_solve(void *handle, int nrhs, double *x, int job);

/* Release a handle. */
int spllt_tpu_free(void *handle);

/* Tear down the embedded runtime (optional). */
void spllt_tpu_finalize(void);

#ifdef __cplusplus
}
#endif
#endif /* SPLLT_TPU_H */
