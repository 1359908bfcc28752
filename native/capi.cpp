// C ABI for spllt_tpu: embeds CPython and drives spllt_tpu.capi.
//
// Analogue of the reference's Fortran bind(C) interface
// (/root/reference/interfaces/C/spllt_data_ciface.F90, 780 LoC): here the
// solver runtime is a Python/JAX framework, so the C shim owns an embedded
// interpreter instead of wrapping Fortran.  Raw pointers cross into Python
// as integers; spllt_tpu/capi.py wraps them with ctypes+numpy.
//
// Build (see native/Makefile):
//   g++ -O2 -shared -fPIC capi.cpp $(python3-config --includes) \
//       $(python3-config --ldflags --embed) -o libspllt_tpu_c.so

#include <Python.h>

#include <cstdint>
#include <cstdio>

#include "../include/spllt_tpu.h"

namespace {

bool g_we_initialized = false;

PyObject *capi_module() {
  static PyObject *mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("spllt_tpu.capi");
    if (!mod) PyErr_Print();
  }
  return mod;
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

int spllt_tpu_init(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // release the GIL acquired by Py_Initialize so Gil{} works below
    PyEval_SaveThread();
  }
  Gil gil;
  return capi_module() ? 0 : -3;
}

int spllt_tpu_analyse(void **handle, const spllt_tpu_options_t *options,
                      int64_t n, const int64_t *ptr, const int64_t *row,
                      spllt_tpu_inform_t *inform) {
  if (spllt_tpu_init() != 0) return -3;
  spllt_tpu_options_t defaults = SPLLT_TPU_OPTIONS_DEFAULT;
  const spllt_tpu_options_t *o = options ? options : &defaults;
  Gil gil;
  PyObject *res = PyObject_CallMethod(
      capi_module(), "analyse_c", "LLLLiisssi", (long long)n,
      (long long)(n + 1), (long long)(uintptr_t)ptr,
      (long long)(uintptr_t)row, o->nb, o->nemin, o->ordering,
      o->schedule, o->precision, o->refine);
  if (!res) {
    PyErr_Print();
    return -3;
  }
  if (!PyTuple_Check(res) || PyTuple_Size(res) < 4) {
    // analyse_c must return (handle, num_factor, num_flops, num_nodes);
    // anything else would leave a pending CPython error in the next call
    Py_DECREF(res);
    PyErr_Clear();
    return -3;
  }
  long long h = PyLong_AsLongLong(PyTuple_GetItem(res, 0));
  if (inform) {
    inform->num_factor = PyLong_AsLongLong(PyTuple_GetItem(res, 1));
    inform->num_flops = PyFloat_AsDouble(PyTuple_GetItem(res, 2));
    inform->num_nodes = PyLong_AsLongLong(PyTuple_GetItem(res, 3));
  }
  if (PyErr_Occurred()) {
    PyErr_Clear();
    Py_DECREF(res);
    return -3;
  }
  Py_DECREF(res);
  if (h <= 0) return -3;
  *handle = (void *)(uintptr_t)h;
  return 0;
}

static int call_int(const char *name, const char *fmt, ...) {
  Gil gil;
  // capi_module() is NULL when the spllt_tpu import failed (e.g. bad
  // PYTHONPATH under a host-initialized interpreter); free/finalize
  // paths reach here without the init guard, so fail soft, not segv
  if (!capi_module()) return -3;
  va_list ap;
  va_start(ap, fmt);
  PyObject *meth = PyObject_GetAttrString(capi_module(), name);
  PyObject *args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  if (!meth || !args) {
    PyErr_Print();
    Py_XDECREF(meth);
    Py_XDECREF(args);
    return -3;
  }
  PyObject *res = PyObject_CallObject(meth, args);
  Py_DECREF(meth);
  Py_DECREF(args);
  if (!res) {
    PyErr_Print();
    return -3;
  }
  int rc = (int)PyLong_AsLong(res);
  Py_DECREF(res);
  return rc;
}

int spllt_tpu_factor(void *handle, const double *val) {
  if (spllt_tpu_init() != 0) return -3;
  return call_int("factor_c", "(LL)", (long long)(uintptr_t)handle,
                  (long long)(uintptr_t)val);
}

int spllt_tpu_solve(void *handle, int nrhs, double *x, int job) {
  if (spllt_tpu_init() != 0) return -3;
  return call_int("solve_c", "(LiLi)", (long long)(uintptr_t)handle, nrhs,
                  (long long)(uintptr_t)x, job);
}

int spllt_tpu_free(void *handle) {
  if (!Py_IsInitialized()) return 0;
  return call_int("free_c", "(L)", (long long)(uintptr_t)handle);
}

void spllt_tpu_finalize(void) {
  // embedded-interpreter teardown with live JAX runtimes is unreliable;
  // deliberately a no-op beyond flushing (process exit reclaims)
  fflush(stdout);
  fflush(stderr);
}

}  // extern "C"
