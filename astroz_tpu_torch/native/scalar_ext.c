/* Minimal CPython extension for the native scalar propagator: the
 * per-call path (api.Satrec.sgp4 in a loop) is overhead-bound — ctypes
 * costs ~3.7 us/call in marshalling while the propagation itself is
 * sub-microsecond. This module keeps the WHOLE per-call path in C
 * (reference: the hand-rolled CPython layer serving its 2.5M props/s
 * scalar loop, bindings/python/src/satrec.zig:169-201):
 *
 *   SatCore — owns a copy of the packed element vector plus the epoch
 *   split; sgp4(jd, fr) computes tsince, propagates, stores t/error on
 *   the C struct, and hand-builds the (e, (x,y,z), (vx,vy,vz)) result
 *   (no Py_BuildValue format parsing). api.Satrec binds the core's
 *   sgp4 as an instance attribute, so loop calls never enter Python.
 *
 * Compiled with scalar_sgp4.cpp by native/__init__.py (plain Python.h,
 * no pybind11/setuptools). The module is named _astroz_torch_scalar so
 * that it can share a process with the JAX package's _astroz_scalar.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C"
#endif
int astroz_scalar_sgp4(const double* s, double tsince, double* out6);

#define SATCORE_NFIELDS 92 /* must cover native.SCALAR_FIELDS (checked) */

typedef struct {
  PyObject_HEAD
  double vec[SATCORE_NFIELDS];
  double jdsatepoch;
  double jdsatepochF;
  double t;     /* minutes since epoch of the last call */
  int error;    /* python-sgp4 error code of the last call */
  PyObject* last;  /* cached result tuple for refcnt-1 reuse */
} SatCore;

static PyObject* build_result(int e, const double* o) {
  PyObject* r = PyTuple_New(3);
  PyObject* rv = PyTuple_New(3);
  PyObject* vv = PyTuple_New(3);
  if (!r || !rv || !vv) {
    Py_XDECREF(r); Py_XDECREF(rv); Py_XDECREF(vv);
    return NULL;
  }
  for (int i = 0; i < 3; ++i) {
    PyTuple_SET_ITEM(rv, i, PyFloat_FromDouble(o[i]));
    PyTuple_SET_ITEM(vv, i, PyFloat_FromDouble(o[3 + i]));
  }
  PyTuple_SET_ITEM(r, 0, PyLong_FromLong(e));
  PyTuple_SET_ITEM(r, 1, rv);
  PyTuple_SET_ITEM(r, 2, vv);
  return r;
}

/* Overwrite the 3 floats of an inner tuple in place where they are
 * exclusively owned (refcnt 1, exact float) — the zip()-style result
 * reuse: a hot `for _: sat.sgp4(jd, fr)` loop discards each result,
 * so steady state does ZERO allocations. Falls back to fresh floats
 * per slot otherwise. Returns 0 on success, -1 on alloc failure. */
static int refill_triple(PyObject* tup, const double* o) {
  for (int i = 0; i < 3; ++i) {
    PyObject* f = PyTuple_GET_ITEM(tup, i);
    if (f && PyFloat_CheckExact(f) && Py_REFCNT(f) == 1) {
      ((PyFloatObject*)f)->ob_fval = o[i];
    } else {
      PyObject* nf = PyFloat_FromDouble(o[i]);
      if (!nf) return -1;
      PyTuple_SET_ITEM(tup, i, nf);  /* steals nf */
      Py_XDECREF(f);
    }
  }
  return 0;
}

/* Build (e, (x,y,z), (vx,vy,vz)) reusing self->last when the caller
 * discarded the previous result (all refcounts back to 1). */
static PyObject* core_result(SatCore* self, int e, const double* o) {
  PyObject* r = self->last;
  if (r && Py_REFCNT(r) == 1) {
    PyObject* rv = PyTuple_GET_ITEM(r, 1);
    PyObject* vv = PyTuple_GET_ITEM(r, 2);
    if (rv && vv && Py_REFCNT(rv) == 1 && Py_REFCNT(vv) == 1 &&
        PyTuple_CheckExact(rv) && PyTuple_CheckExact(vv)) {
      PyObject* e_old = PyTuple_GET_ITEM(r, 0);
      if (!e_old || !PyLong_CheckExact(e_old) ||
          PyLong_AsLong(e_old) != (long)e) {
        PyObject* ne = PyLong_FromLong(e);
        if (!ne) return NULL;
        PyTuple_SET_ITEM(r, 0, ne);
        Py_XDECREF(e_old);
      }
      double vo[3] = {o[3], o[4], o[5]};
      if (refill_triple(rv, o) < 0 || refill_triple(vv, vo) < 0)
        return NULL;
      Py_INCREF(r);
      return r;
    }
  }
  PyObject* fresh = build_result(e, o);
  if (!fresh) return NULL;
  Py_XDECREF(self->last);
  self->last = fresh;
  Py_INCREF(fresh);  /* one ref cached, one returned */
  return fresh;
}

/* core.sgp4(jd, fr) -> (e, (x,y,z), (vx,vy,vz)) — full python-sgp4
 * call semantics in one C round trip. */
static PyObject* satcore_sgp4(SatCore* self, PyObject* const* args,
                              Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "sgp4(jd, fr)");
    return NULL;
  }
  /* exact-float fast path: skips the PyFloat_AsDouble call + the
   * PyErr_Occurred thread-state fetch on the hot loop (jd/fr are
   * virtually always Python floats) */
  double jd, fr;
  if (PyFloat_CheckExact(args[0]) && PyFloat_CheckExact(args[1])) {
    jd = PyFloat_AS_DOUBLE(args[0]);
    fr = PyFloat_AS_DOUBLE(args[1]);
  } else {
    jd = PyFloat_AsDouble(args[0]);
    fr = PyFloat_AsDouble(args[1]);
    if (PyErr_Occurred()) return NULL;
  }
  double tsince =
      ((jd - self->jdsatepoch) + (fr - self->jdsatepochF)) * 1440.0;
  double out[6];
  int e = astroz_scalar_sgp4(self->vec, tsince, out);
  self->t = tsince;
  self->error = e;
  return core_result(self, e, out);
}

/* core.sgp4_tsince(tsince_min) — python-sgp4 parity entry. */
static PyObject* satcore_sgp4_tsince(SatCore* self, PyObject* const* args,
                                     Py_ssize_t nargs) {
  if (nargs != 1) {
    PyErr_SetString(PyExc_TypeError, "sgp4_tsince(tsince_min)");
    return NULL;
  }
  double tsince;
  if (PyFloat_CheckExact(args[0])) {
    tsince = PyFloat_AS_DOUBLE(args[0]);
  } else {
    tsince = PyFloat_AsDouble(args[0]);
    if (PyErr_Occurred()) return NULL;
  }
  double out[6];
  int e = astroz_scalar_sgp4(self->vec, tsince, out);
  self->t = tsince;
  self->error = e;
  return core_result(self, e, out);
}

static PyMethodDef satcore_methods[] = {
    {"sgp4", (PyCFunction)(void (*)(void))satcore_sgp4, METH_FASTCALL,
     "sgp4(jd, fr) -> (e, r, v)"},
    {"sgp4_tsince", (PyCFunction)(void (*)(void))satcore_sgp4_tsince,
     METH_FASTCALL, "sgp4_tsince(tsince_min) -> (e, r, v)"},
    {NULL, NULL, 0, NULL}};

static PyMemberDef satcore_members[] = {
    {"t", Py_T_DOUBLE, offsetof(SatCore, t), 0,
     "minutes since epoch of the last propagation"},
    {"error", Py_T_INT, offsetof(SatCore, error), 0,
     "python-sgp4 error code of the last propagation"},
    {NULL, 0, 0, 0, NULL}};

/* SatCore(vec_addr: int, n: int, jdsatepoch: float, jdsatepochF: float)
 * — copies n doubles out of the packed element vector (the Python side
 * may free its copy afterwards). */
static int satcore_init(SatCore* self, PyObject* args, PyObject* kwds) {
  unsigned long long addr;
  Py_ssize_t n;
  double ep, epf;
  (void)kwds;
  if (!PyArg_ParseTuple(args, "Kndd", &addr, &n, &ep, &epf)) return -1;
  if (n <= 0 || n > SATCORE_NFIELDS) {
    PyErr_SetString(PyExc_ValueError, "element vector size mismatch");
    return -1;
  }
  memset(self->vec, 0, sizeof(self->vec));
  memcpy(self->vec, (const double*)(uintptr_t)addr,
         (size_t)n * sizeof(double));
  self->jdsatepoch = ep;
  self->jdsatepochF = epf;
  self->t = 0.0;
  self->error = 0;
  Py_CLEAR(self->last);
  return 0;
}

static void satcore_dealloc(SatCore* self) {
  Py_CLEAR(self->last);
  Py_TYPE(self)->tp_free((PyObject*)self);
}

/* designators in PyTypeObject declaration order: this file is built by
 * g++ (C++ rules), where out-of-order designated initializers are a
 * hard error — tp_dealloc must precede tp_flags. */
static PyTypeObject SatCoreType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_astroz_torch_scalar.SatCore",
    .tp_basicsize = sizeof(SatCore),
    .tp_dealloc = (destructor)satcore_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Native per-satellite scalar SGP4/SDP4 propagator core.",
    .tp_methods = satcore_methods,
    .tp_members = satcore_members,
    .tp_init = (initproc)satcore_init,
    .tp_new = PyType_GenericNew,
};

/* propagate(vec_addr: int, tsince: float) -> (e, (x,y,z), (vx,vy,vz))
 * vec_addr is the data pointer of the packed element vector (owned and
 * kept alive by the Python-side ScalarEngine). */
static PyObject* propagate(PyObject* self, PyObject* const* args,
                           Py_ssize_t nargs) {
  (void)self;
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "propagate(vec_addr, tsince_min)");
    return NULL;
  }
  unsigned long long addr = PyLong_AsUnsignedLongLong(args[0]);
  double tsince = PyFloat_AsDouble(args[1]);
  if (PyErr_Occurred()) return NULL;
  double out[6];
  int e = astroz_scalar_sgp4((const double*)(uintptr_t)addr, tsince, out);
  return build_result(e, out);
}

static PyMethodDef methods[] = {
    {"propagate", (PyCFunction)(void (*)(void))propagate, METH_FASTCALL,
     "propagate(vec_addr, tsince_min) -> (e, r, v)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_astroz_torch_scalar",
    "Native scalar SGP4/SDP4 single-point propagator.", -1, methods};

PyMODINIT_FUNC PyInit__astroz_torch_scalar(void) {
  if (PyType_Ready(&SatCoreType) < 0) return NULL;
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return NULL;
  Py_INCREF(&SatCoreType);
  if (PyModule_AddObject(m, "SatCore", (PyObject*)&SatCoreType) < 0) {
    Py_DECREF(&SatCoreType);
    Py_DECREF(m);
    return NULL;
  }
  return m;
}
