/* C-interface example: analyse / factor / solve a small SPD system.
 *
 * Analogue of the reference's example/C/simple.c driving its Fortran
 * bind(C) interface; here the library embeds the Python/JAX runtime.
 *
 * Build + run:  make -C native example
 * (set PYTHONPATH to the repo root so the embedded interpreter finds
 *  spllt_tpu; JAX_PLATFORMS=cpu runs without a GPU.)
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#include "spllt_tpu.h"

int main(void) {
  /* 1-D Laplacian, n x n tridiagonal SPD, CSC lower triangle */
  const int64_t n = 64;
  int64_t *ptr = malloc((n + 1) * sizeof *ptr);
  int64_t *row = malloc(2 * n * sizeof *row);
  double *val = malloc(2 * n * sizeof *val);
  int64_t nz = 0;
  for (int64_t j = 0; j < n; ++j) {
    ptr[j] = nz;
    row[nz] = j;
    val[nz++] = 2.0;
    if (j + 1 < n) {
      row[nz] = j + 1;
      val[nz++] = -1.0;
    }
  }
  ptr[n] = nz;

  spllt_tpu_options_t opts = SPLLT_TPU_OPTIONS_DEFAULT;
  opts.nb = 16;
  opts.ordering = "natural";

  spllt_tpu_inform_t inform;
  void *h = NULL;
  if (spllt_tpu_analyse(&h, &opts, n, ptr, row, &inform) != 0) {
    fprintf(stderr, "analyse failed\n");
    return 1;
  }
  printf("analyse: nnz(L)=%lld flops=%.3e nodes=%lld\n",
         (long long)inform.num_factor, inform.num_flops,
         (long long)inform.num_nodes);

  if (spllt_tpu_factor(h, val) != 0) {
    fprintf(stderr, "factor failed\n");
    return 1;
  }

  /* rhs for the known solution x* = 1: b = A 1 */
  double *x = malloc(n * sizeof *x);
  for (int64_t i = 0; i < n; ++i) x[i] = 0.0;
  x[0] = 1.0;
  x[n - 1] = 1.0;   /* interior rows of A*1 are 0 for the 1-D Laplacian */

  if (spllt_tpu_solve(h, 1, x, 0) != 0) {
    fprintf(stderr, "solve failed\n");
    return 1;
  }
  double err = 0.0;
  for (int64_t i = 0; i < n; ++i) err = fmax(err, fabs(x[i] - 1.0));
  printf("solve: max |x - 1| = %.3e\n", err);
  spllt_tpu_free(h);
  if (err > 1e-10) {
    fprintf(stderr, "FAILED\n");
    return 1;
  }
  printf("ok\n");
  return 0;
}
