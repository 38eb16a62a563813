/* CPython extension: C-native FASTQ record/view objects + chain iterator.
 *
 * Per-record-object throughput is bounded by CPython work per record. This
 * module drops it to a few C operations:
 *
 *   Record  — owned record as ONE variable-size object: header bytes, the
 *             id/seq/qual payloads live in the object's tail (single
 *             allocation + one memcpy per span); `_id/_sequence/_quality`
 *             materialize lazily as bytes on access. (The roadmap's
 *             "full C record type": tp_alloc single-block layout, lazy
 *             field getters.)
 *   View    — zero-copy record view: three (owner, ptr, len) references
 *             into the parser window; one allocation, no byte copies.
 *   ChainIter — iterator serving Record/View instances straight from a
 *             scanned offset table, pulling (buffer, rows) batches from a
 *             Python refill callable; an epoch word (int64[1] shared with
 *             the parser) invalidates the snapshot when the parser's
 *             queue moves underneath, preserving the exact mixed-usage
 *             semantics of the Python generators.
 *
 * Reference behavior spec: blazeseq/fastq/record.mojo:230-551 (records and
 * views), utils.mojo:223-242 (id whitespace strip).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <stdint.h>
#include <string.h>

/* POSIX whitespace per the reference strip set (utils.mojo:223-242) */
static unsigned char WS[256];

/* Python-side helpers registered by fastq/record.py after import
 * (np.frombuffer-based phred decode, Definition construction,
 * from_string parsing) — lets the C types expose the full Python API
 * without circular imports. */
static PyObject *H_definition = NULL;   /* f(id_bytes) -> Definition */
static PyObject *H_phred = NULL;        /* f(qual_bytes, offset) -> ndarray */
static PyObject *H_from_string = NULL;  /* f(cls, str) -> record */

static void init_ws(void) {
    memset(WS, 0, sizeof(WS));
    WS[' '] = WS['\t'] = WS['\n'] = WS['\v'] = WS['\f'] = WS['\r'] = 1;
    WS[0x1c] = WS[0x1d] = WS[0x1e] = 1;
}

/* ------------------------------------------------------------------ */
/* Record: owned, single-block                                         */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_VAR_HEAD           /* ob_size = total tail bytes */
    long phred_offset;
    Py_ssize_t id_len, seq_len, qual_len;
    char data[1];               /* id + seq + qual, contiguous */
} RecObj;

/* Freelist for exact-type Records in one size class: records up to
 * REC_FL_CAP tail bytes (id+seq+qual; covers short-read data) allocate a
 * fixed-capacity block so dead shells can be recycled without the
 * malloc + memset round-trip — records-mode iteration creates and
 * destroys one per record. Set at module init (C++-friendly, same
 * pattern as ViewTypeExact). */
#define REC_FL_CAP 256
#define REC_FREELIST_MAX 64
static RecObj *rec_freelist[REC_FREELIST_MAX];
static int rec_freelist_n = 0;
static PyTypeObject *RecTypeExact = NULL;

static void Rec_dealloc(PyObject *self) {
    /* only exact-type objects with size <= REC_FL_CAP were allocated with
     * the padded fixed-capacity tail (see Rec_alloc_fill), so only those
     * are safe to recycle for any payload up to the cap */
    if (Py_IS_TYPE(self, RecTypeExact) && Py_SIZE(self) <= REC_FL_CAP &&
        rec_freelist_n < REC_FREELIST_MAX) {
        rec_freelist[rec_freelist_n++] = (RecObj *)self;
        return;
    }
    Py_TYPE(self)->tp_free(self);
}

static PyObject *Rec_alloc_fill(PyTypeObject *subtype, const uint8_t *id,
                                Py_ssize_t id_len, const uint8_t *seq,
                                Py_ssize_t seq_len, const uint8_t *qual,
                                Py_ssize_t qual_len, long phred) {
    const Py_ssize_t total = id_len + seq_len + qual_len;
    RecObj *r;
    if (subtype == RecTypeExact && total <= REC_FL_CAP) {
        if (rec_freelist_n > 0) {
            r = rec_freelist[--rec_freelist_n];
            PyObject_InitVar((PyVarObject *)r, RecTypeExact, total);
        } else {
            r = (RecObj *)subtype->tp_alloc(subtype, REC_FL_CAP);
            if (!r) return NULL;
            Py_SET_SIZE(r, total);
        }
    } else {
        r = (RecObj *)subtype->tp_alloc(subtype, total);
        if (!r) return NULL;
    }
    r->phred_offset = phred;
    r->id_len = id_len;
    r->seq_len = seq_len;
    r->qual_len = qual_len;
    char *d = r->data;
    memcpy(d, id, (size_t)id_len);
    memcpy(d + id_len, seq, (size_t)seq_len);
    memcpy(d + id_len + seq_len, qual, (size_t)qual_len);
    return (PyObject *)r;
}

/* accepts bytes-like or str; fills (ptr, len) via a held Py_buffer or an
 * owned temporary bytes object (returned for the caller to decref). */
static int as_span(PyObject *obj, Py_buffer *view, PyObject **tmp,
                   const uint8_t **ptr, Py_ssize_t *len) {
    *tmp = NULL;
    if (PyUnicode_Check(obj)) {
        *tmp = PyUnicode_AsEncodedString(obj, "utf-8", "strict");
        if (!*tmp) return -1;
        *ptr = (const uint8_t *)PyBytes_AS_STRING(*tmp);
        *len = PyBytes_GET_SIZE(*tmp);
        view->obj = NULL;
        return 0;
    }
    if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) < 0) return -1;
    *ptr = (const uint8_t *)view->buf;
    *len = view->len;
    return 0;
}

static PyObject *Rec_new(PyTypeObject *subtype, PyObject *args,
                         PyObject *kwds) {
    static char *kwlist[] = {"id", "sequence", "quality", "schema",
                             "phred_offset", NULL};
    PyObject *id_o, *seq_o, *qual_o;
    PyObject *schema = Py_None, *phred_o = Py_None;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "OOO|OO", kwlist, &id_o,
                                     &seq_o, &qual_o, &schema, &phred_o))
        return NULL;
    long phred = 33;
    if (phred_o != Py_None) {
        phred = PyLong_AsLong(phred_o);
        if (phred == -1 && PyErr_Occurred()) return NULL;
    } else if (schema != Py_None) {
        PyObject *off = PyObject_GetAttrString(schema, "OFFSET");
        if (!off) return NULL;
        phred = PyLong_AsLong(off);
        Py_DECREF(off);
        if (phred == -1 && PyErr_Occurred()) return NULL;
    }
    Py_buffer bv[3];
    PyObject *tmp[3] = {NULL, NULL, NULL};
    const uint8_t *p[3];
    Py_ssize_t ln[3];
    PyObject *objs[3] = {id_o, seq_o, qual_o};
    PyObject *result = NULL;
    int held = 0;
    for (; held < 3; ++held) {
        if (as_span(objs[held], &bv[held], &tmp[held], &p[held],
                    &ln[held]) < 0)
            goto done;
    }
    result = Rec_alloc_fill(subtype, p[0], ln[0], p[1], ln[1], p[2], ln[2],
                            phred);
done:
    for (int i = 0; i < held; ++i) {
        if (tmp[i]) Py_DECREF(tmp[i]);
        else if (bv[i].obj) PyBuffer_Release(&bv[i]);
    }
    return result;
}

static PyObject *Rec_get_id(RecObj *self, void *_) {
    return PyBytes_FromStringAndSize(self->data, self->id_len);
}
static PyObject *Rec_get_seq(RecObj *self, void *_) {
    return PyBytes_FromStringAndSize(self->data + self->id_len,
                                     self->seq_len);
}
static PyObject *Rec_get_qual(RecObj *self, void *_) {
    return PyBytes_FromStringAndSize(self->data + self->id_len +
                                         self->seq_len,
                                     self->qual_len);
}
static PyObject *Rec_get_phred(RecObj *self, void *_) {
    return PyLong_FromLong(self->phred_offset);
}

static PyObject *Rec_id_bytes(RecObj *self, PyObject *_) {
    return Rec_get_id(self, NULL);
}
static PyObject *Rec_seq_bytes(RecObj *self, PyObject *_) {
    return Rec_get_seq(self, NULL);
}
static PyObject *Rec_qual_bytes(RecObj *self, PyObject *_) {
    return Rec_get_qual(self, NULL);
}
static PyObject *Rec_byte_len(RecObj *self, PyObject *_) {
    return PyLong_FromSsize_t(1 + self->id_len + self->seq_len +
                              self->qual_len + 5);
}

static Py_ssize_t Rec_length(RecObj *self) { return self->seq_len; }

static PyObject *Rec_to_bytes_raw(const char *id, Py_ssize_t idl,
                                  const char *seq, Py_ssize_t seql,
                                  const char *qual, Py_ssize_t quall) {
    /* '@' + id + '\n' + seq + '\n' + "+\n" + qual + '\n' */
    const Py_ssize_t total = 1 + idl + 1 + seql + 1 + 2 + quall + 1;
    PyObject *b = PyBytes_FromStringAndSize(NULL, total);
    if (!b) return NULL;
    char *d = PyBytes_AS_STRING(b);
    *d++ = '@';
    memcpy(d, id, (size_t)idl); d += idl;
    *d++ = '\n';
    memcpy(d, seq, (size_t)seql); d += seql;
    *d++ = '\n'; *d++ = '+'; *d++ = '\n';
    memcpy(d, qual, (size_t)quall); d += quall;
    *d++ = '\n';
    return b;
}

static PyObject *generic_write(PyObject *self, PyObject *writer) {
    PyObject *b = PyObject_CallMethod(self, "to_bytes", NULL);
    if (!b) return NULL;
    PyObject *r = PyObject_CallMethod(writer, "write_bytes", "O", b);
    Py_DECREF(b);
    if (!r) return NULL;
    Py_DECREF(r);
    Py_RETURN_NONE;
}

static PyObject *generic_repr(PyObject *self) {
    PyObject *b = PyObject_CallMethod(self, "to_bytes", NULL);
    if (!b) return NULL;
    PyObject *u = PyUnicode_DecodeUTF8(PyBytes_AS_STRING(b),
                                       PyBytes_GET_SIZE(b), "replace");
    Py_DECREF(b);
    return u;
}

static PyObject *generic_definition(PyObject *self, PyObject *noarg) {
    if (!H_definition) {
        PyErr_SetString(PyExc_RuntimeError, "helpers not registered");
        return NULL;
    }
    PyObject *idb = PyObject_CallMethod(self, "id_bytes", NULL);
    if (!idb) return NULL;
    PyObject *r = PyObject_CallOneArg(H_definition, idb);
    Py_DECREF(idb);
    return r;
}

static PyObject *generic_phred(PyObject *self, PyObject *args,
                               PyObject *kwds) {
    static char *kwlist[] = {"offset", NULL};
    PyObject *off = Py_None;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|O", kwlist, &off))
        return NULL;
    if (!H_phred) {
        PyErr_SetString(PyExc_RuntimeError, "helpers not registered");
        return NULL;
    }
    PyObject *qb = PyObject_CallMethod(self, "quality_bytes", NULL);
    if (!qb) return NULL;
    PyObject *offv = off;
    if (off == Py_None) {
        offv = PyObject_GetAttrString(self, "_phred_offset");
        if (!offv) { Py_DECREF(qb); return NULL; }
    } else {
        Py_INCREF(offv);
    }
    PyObject *r = PyObject_CallFunctionObjArgs(H_phred, qb, offv, NULL);
    Py_DECREF(qb);
    Py_DECREF(offv);
    return r;
}

static PyObject *generic_from_string(PyObject *cls, PyObject *arg) {
    if (!H_from_string) {
        PyErr_SetString(PyExc_RuntimeError, "helpers not registered");
        return NULL;
    }
    return PyObject_CallFunctionObjArgs(H_from_string, cls, arg, NULL);
}

static PyObject *decode_method(PyObject *self, const char *meth) {
    PyObject *b = PyObject_CallMethod(self, meth, NULL);
    if (!b) return NULL;
    PyObject *u = PyUnicode_DecodeUTF8(PyBytes_AS_STRING(b),
                                       PyBytes_GET_SIZE(b), "replace");
    Py_DECREF(b);
    return u;
}

static PyObject *Rec_id_str(PyObject *self, PyObject *_) {
    return decode_method(self, "id_bytes");
}
static PyObject *Rec_seq_str(PyObject *self, PyObject *_) {
    return decode_method(self, "sequence_bytes");
}
static PyObject *Rec_qual_str(PyObject *self, PyObject *_) {
    return decode_method(self, "quality_bytes");
}

static PyObject *Rec_reduce(RecObj *self, PyObject *_) {
    /* pickle support (the pure-Python record pickles; keep parity):
     * reconstruct via the constructor from the three byte spans */
    PyObject *id_b = Rec_get_id(self, NULL);
    PyObject *seq_b = Rec_get_seq(self, NULL);
    PyObject *qual_b = Rec_get_qual(self, NULL);
    if (!id_b || !seq_b || !qual_b) {
        Py_XDECREF(id_b); Py_XDECREF(seq_b); Py_XDECREF(qual_b);
        return NULL;
    }
    PyObject *args = Py_BuildValue("(NNNOl)", id_b, seq_b, qual_b, Py_None,
                                   self->phred_offset);
    if (!args) return NULL;
    return Py_BuildValue("(ON)", (PyObject *)Py_TYPE(self), args);
}

static PyObject *Rec_to_bytes(RecObj *self, PyObject *_) {
    return Rec_to_bytes_raw(self->data, self->id_len,
                            self->data + self->id_len, self->seq_len,
                            self->data + self->id_len + self->seq_len,
                            self->qual_len);
}

static Py_hash_t Rec_hash(RecObj *self) {
    PyObject *b = Rec_get_seq(self, NULL);
    if (!b) return -1;
    Py_hash_t h = PyObject_Hash(b);
    Py_DECREF(b);
    return h;
}

/* equality on sequence bytes, accepting any record/view-like object with a
 * `_sequence` attribute (pure-Python variants included) */
static PyObject *seq_richcompare(PyObject *self, PyObject *other, int op) {
    if (op != Py_EQ && op != Py_NE) Py_RETURN_NOTIMPLEMENTED;
    PyObject *os = PyObject_GetAttrString(other, "_sequence");
    if (!os) {
        PyErr_Clear();
        if (op == Py_EQ) Py_RETURN_FALSE;
        Py_RETURN_TRUE;
    }
    PyObject *ob = PyBytes_FromObject(os);
    Py_DECREF(os);
    if (!ob) return NULL;
    PyObject *ms = PyObject_GetAttrString(self, "_sequence");
    if (!ms) { Py_DECREF(ob); return NULL; }
    PyObject *mb = PyBytes_FromObject(ms);
    Py_DECREF(ms);
    if (!mb) { Py_DECREF(ob); return NULL; }
    const int eq = (PyBytes_GET_SIZE(mb) == PyBytes_GET_SIZE(ob)
                    && memcmp(PyBytes_AS_STRING(mb), PyBytes_AS_STRING(ob),
                              (size_t)PyBytes_GET_SIZE(mb)) == 0);
    Py_DECREF(mb);
    Py_DECREF(ob);
    if ((op == Py_EQ) == (eq != 0)) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyGetSetDef Rec_getsets[] = {
    {"_id", (getter)Rec_get_id, NULL, "id bytes", NULL},
    {"_sequence", (getter)Rec_get_seq, NULL, "sequence bytes", NULL},
    {"_quality", (getter)Rec_get_qual, NULL, "quality bytes", NULL},
    {"_phred_offset", (getter)Rec_get_phred, NULL, "phred offset", NULL},
    {NULL},
};

static PyMethodDef Rec_methods[] = {
    {"id_bytes", (PyCFunction)Rec_id_bytes, METH_NOARGS, NULL},
    {"sequence_bytes", (PyCFunction)Rec_seq_bytes, METH_NOARGS, NULL},
    {"quality_bytes", (PyCFunction)Rec_qual_bytes, METH_NOARGS, NULL},
    {"byte_len", (PyCFunction)Rec_byte_len, METH_NOARGS, NULL},
    {"id", (PyCFunction)Rec_id_str, METH_NOARGS, NULL},
    {"sequence", (PyCFunction)Rec_seq_str, METH_NOARGS, NULL},
    {"quality", (PyCFunction)Rec_qual_str, METH_NOARGS, NULL},
    {"to_bytes", (PyCFunction)Rec_to_bytes, METH_NOARGS, NULL},
    {"write", (PyCFunction)generic_write, METH_O, NULL},
    {"definition", (PyCFunction)generic_definition, METH_NOARGS, NULL},
    {"phred_scores", (PyCFunction)generic_phred,
     METH_VARARGS | METH_KEYWORDS, NULL},
    {"from_string", (PyCFunction)generic_from_string,
     METH_O | METH_CLASS, NULL},
    {"__reduce__", (PyCFunction)Rec_reduce, METH_NOARGS, NULL},
    {NULL},
};

static PySequenceMethods Rec_as_seq = {
    .sq_length = (lenfunc)Rec_length,
};

static PyTypeObject RecType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "blazeseq_tpu.FastqRecord",
    .tp_basicsize = offsetof(RecObj, data),
    .tp_itemsize = 1,
    .tp_dealloc = Rec_dealloc,
    .tp_repr = generic_repr,
    .tp_as_sequence = &Rec_as_seq,
    .tp_hash = (hashfunc)Rec_hash,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_doc = "Owned FASTQ record (single-block C storage).",
    .tp_richcompare = seq_richcompare,
    .tp_methods = Rec_methods,
    .tp_getset = Rec_getsets,
    .tp_new = Rec_new,
};

/* ------------------------------------------------------------------ */
/* View: zero-copy                                                     */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    PyObject *own[3];           /* keep-alive owners (may be same object) */
    const uint8_t *ptr[3];      /* id, seq, qual */
    Py_ssize_t len[3];
    Py_buffer bufs[3];          /* held when constructed from Python */
    int nbufs;
    long phred_offset;
} ViewObj;

/* Freelist for exact-type View objects: in views-mode iteration every view
 * dies immediately after inspection, so the malloc/free round-trip in
 * tp_alloc/tp_free is pure overhead on the per-record floor. The chain
 * iterator pops from here; dealloc pushes back (bounded). */
#define VIEW_FREELIST_MAX 64
static ViewObj *view_freelist[VIEW_FREELIST_MAX];
static int view_freelist_n = 0;
/* set to &ViewType at module init (the type object is defined below;
 * builds as C++ too, where a tentative definition is unavailable) */
static PyTypeObject *ViewTypeExact = NULL;

static void View_dealloc(ViewObj *self) {
    for (int i = 0; i < self->nbufs; ++i) PyBuffer_Release(&self->bufs[i]);
    for (int i = 0; i < 3; ++i) Py_XDECREF(self->own[i]);
    if (Py_IS_TYPE(self, ViewTypeExact) &&
        view_freelist_n < VIEW_FREELIST_MAX) {
        view_freelist[view_freelist_n++] = self;
        return;
    }
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *View_new(PyTypeObject *subtype, PyObject *args,
                          PyObject *kwds) {
    static char *kwlist[] = {"id_mv", "seq_mv", "qual_mv", "phred_offset",
                             NULL};
    PyObject *o[3];
    long phred = 33;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "OOO|l", kwlist, &o[0],
                                     &o[1], &o[2], &phred))
        return NULL;
    ViewObj *v = (ViewObj *)subtype->tp_alloc(subtype, 0);
    if (!v) return NULL;
    v->nbufs = 0;
    v->phred_offset = phred;
    v->own[0] = v->own[1] = v->own[2] = NULL;
    for (int i = 0; i < 3; ++i) {
        if (PyObject_GetBuffer(o[i], &v->bufs[i], PyBUF_SIMPLE) < 0) {
            Py_DECREF(v);
            return NULL;
        }
        v->nbufs = i + 1;
        v->ptr[i] = (const uint8_t *)v->bufs[i].buf;
        v->len[i] = v->bufs[i].len;
        Py_INCREF(o[i]);
        v->own[i] = o[i];
    }
    return (PyObject *)v;
}

static PyObject *View_mv(ViewObj *self, int i) {
    /* a memoryview tied to the owner's lifetime: slice a fresh view of the
       owner (cold path — hot accessors below return bytes copies).
       Chain-iterator views hold a single owner in own[0] covering all
       three spans (own[1]/own[2] are NULL), so fall back to it — the
       pointer arithmetic below is valid for any span inside the owner. */
    PyObject *owner = self->own[i] ? self->own[i] : self->own[0];
    if (!owner) Py_RETURN_NONE;
    PyObject *full = PyMemoryView_FromObject(owner);
    if (!full) return NULL;
    Py_buffer *fb = PyMemoryView_GET_BUFFER(full);
    const Py_ssize_t start =
        (Py_ssize_t)(self->ptr[i] - (const uint8_t *)fb->buf);
    PyObject *lo = PyLong_FromSsize_t(start);
    PyObject *hi = PyLong_FromSsize_t(start + self->len[i]);
    PyObject *slice = (lo && hi) ? PySlice_New(lo, hi, NULL) : NULL;
    Py_XDECREF(lo);
    Py_XDECREF(hi);
    if (!slice) {
        Py_DECREF(full);
        return NULL;
    }
    PyObject *res = PyObject_GetItem(full, slice);
    Py_DECREF(slice);
    Py_DECREF(full);
    return res;
}

static PyObject *View_get_id(ViewObj *self, void *_) {
    return View_mv(self, 0);
}
static PyObject *View_get_seq(ViewObj *self, void *_) {
    return View_mv(self, 1);
}
static PyObject *View_get_qual(ViewObj *self, void *_) {
    return View_mv(self, 2);
}
static PyObject *View_get_phred(ViewObj *self, void *_) {
    return PyLong_FromLong(self->phred_offset);
}

static PyObject *View_id_bytes(ViewObj *self, PyObject *_) {
    return PyBytes_FromStringAndSize((const char *)self->ptr[0],
                                     self->len[0]);
}
static PyObject *View_seq_bytes(ViewObj *self, PyObject *_) {
    return PyBytes_FromStringAndSize((const char *)self->ptr[1],
                                     self->len[1]);
}
static PyObject *View_qual_bytes(ViewObj *self, PyObject *_) {
    return PyBytes_FromStringAndSize((const char *)self->ptr[2],
                                     self->len[2]);
}
static PyObject *View_byte_len(ViewObj *self, PyObject *_) {
    return PyLong_FromSsize_t(1 + self->len[0] + self->len[1] +
                              self->len[2] + 5);
}

static Py_ssize_t View_length(ViewObj *self) { return self->len[1]; }

static PyGetSetDef View_getsets[] = {
    {"_id", (getter)View_get_id, NULL, "id memoryview", NULL},
    {"_sequence", (getter)View_get_seq, NULL, "sequence memoryview", NULL},
    {"_quality", (getter)View_get_qual, NULL, "quality memoryview", NULL},
    {"_phred_offset", (getter)View_get_phred, NULL, "phred offset", NULL},
    {NULL},
};

static PyObject *View_to_bytes(ViewObj *self, PyObject *_) {
    return Rec_to_bytes_raw((const char *)self->ptr[0], self->len[0],
                            (const char *)self->ptr[1], self->len[1],
                            (const char *)self->ptr[2], self->len[2]);
}

static PyObject *View_to_record(ViewObj *self, PyObject *_) {
    /* owned copy: instance of the registered record type (the C Record
     * itself, or a subclass if one is in use) */
    PyTypeObject *rt = &RecType;
    return Rec_alloc_fill(rt, self->ptr[0], self->len[0], self->ptr[1],
                          self->len[1], self->ptr[2], self->len[2],
                          self->phred_offset);
}

static PyMethodDef View_methods[] = {
    {"id_bytes", (PyCFunction)View_id_bytes, METH_NOARGS, NULL},
    {"sequence_bytes", (PyCFunction)View_seq_bytes, METH_NOARGS, NULL},
    {"quality_bytes", (PyCFunction)View_qual_bytes, METH_NOARGS, NULL},
    {"byte_len", (PyCFunction)View_byte_len, METH_NOARGS, NULL},
    {"id", (PyCFunction)Rec_id_str, METH_NOARGS, NULL},
    {"sequence", (PyCFunction)Rec_seq_str, METH_NOARGS, NULL},
    {"quality", (PyCFunction)Rec_qual_str, METH_NOARGS, NULL},
    {"to_bytes", (PyCFunction)View_to_bytes, METH_NOARGS, NULL},
    {"to_record", (PyCFunction)View_to_record, METH_NOARGS, NULL},
    {"write", (PyCFunction)generic_write, METH_O, NULL},
    {"definition", (PyCFunction)generic_definition, METH_NOARGS, NULL},
    {"phred_scores", (PyCFunction)generic_phred,
     METH_VARARGS | METH_KEYWORDS, NULL},
    {NULL},
};

static PySequenceMethods View_as_seq = {
    .sq_length = (lenfunc)View_length,
};

static PyTypeObject ViewType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "blazeseq_tpu.FastqView",
    .tp_basicsize = sizeof(ViewObj),
    .tp_dealloc = (destructor)View_dealloc,
    .tp_repr = generic_repr,
    .tp_as_sequence = &View_as_seq,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_doc = "Zero-copy FASTQ record view (C storage).",
    .tp_methods = View_methods,
    .tp_getset = View_getsets,
    .tp_new = View_new,
};

/* ------------------------------------------------------------------ */
/* ChainIter                                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    PyObject *refill;         /* callable() -> None | (owner, rows, n, epoch) */
    PyObject *epoch_obj;      /* owner of the shared epoch int64[1] */
    Py_buffer epoch_view;
    const int64_t *epoch;
    int64_t my_epoch;
    PyObject *progress_obj;   /* owner of the shared progress int64[1] */
    Py_buffer progress_view;
    int64_t *progress;        /* mirrors cursor after every serve, so the
                                 parser can commit without referencing this
                                 object (no refcycle through the refill
                                 closure) */
    int progress_held;
    PyObject *buf_obj;        /* current batch buffer owner */
    Py_buffer buf_view;
    const uint8_t *buf;
    Py_ssize_t buf_len;
    PyObject *rows_obj;       /* current batch offsets owner */
    Py_buffer rows_view;
    const int64_t *rows;
    Py_ssize_t count;
    Py_ssize_t cursor;
    long phred;
    PyTypeObject *out_type;   /* View or Record subclass */
    int is_view;
    int held;                 /* buf/rows views held */
    int epoch_held;
    int exhausted;
    int reuse;                /* views(reuse=True): serve ONE mutated shell */
    ViewObj *reuse_view;      /* iterator-owned shell for reuse mode */
} ChainIter;

static void Chain_drop_batch(ChainIter *self) {
    if (self->held) {
        PyBuffer_Release(&self->buf_view);
        PyBuffer_Release(&self->rows_view);
        self->held = 0;
    }
    Py_CLEAR(self->buf_obj);
    Py_CLEAR(self->rows_obj);
    self->rows = NULL;
    self->buf = NULL;
    self->count = 0;
    self->cursor = 0;
}

static void Chain_dealloc(ChainIter *self) {
    Chain_drop_batch(self);
    Py_XDECREF((PyObject *)self->reuse_view);
    if (self->epoch_held) PyBuffer_Release(&self->epoch_view);
    if (self->progress_held) PyBuffer_Release(&self->progress_view);
    Py_XDECREF(self->epoch_obj);
    Py_XDECREF(self->progress_obj);
    Py_XDECREF(self->refill);
    Py_XDECREF((PyObject *)self->out_type);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int Chain_refill(ChainIter *self) {
    /* returns 1 = new batch ready, 0 = EOF (StopIteration), -1 = error.
     * The refill callable receives the number of records served from the
     * CURRENT snapshot, so the parser can commit its cursor before
     * producing the next snapshot (the old buffers stay held across the
     * call; _scan_more may grow/replace the stream buffer underneath). */
    if (self->exhausted) return 0;
    PyObject *served = PyLong_FromSsize_t(self->cursor);
    if (!served) return -1;
    PyObject *res = PyObject_CallOneArg(self->refill, served);
    Py_DECREF(served);
    Chain_drop_batch(self);
    if (!res) return -1;
    if (res == Py_None) {
        Py_DECREF(res);
        self->exhausted = 1;
        return 0;
    }
    PyObject *owner, *rows;
    Py_ssize_t n;
    long long epoch;
    if (!PyArg_ParseTuple(res, "OOnL", &owner, &rows, &n, &epoch)) {
        Py_DECREF(res);
        return -1;
    }
    if (PyObject_GetBuffer(owner, &self->buf_view, PyBUF_SIMPLE) < 0) {
        Py_DECREF(res);
        return -1;
    }
    if (PyObject_GetBuffer(rows, &self->rows_view, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&self->buf_view);
        Py_DECREF(res);
        return -1;
    }
    self->held = 1;
    if ((Py_ssize_t)(n * 5 * (Py_ssize_t)sizeof(int64_t)) >
        self->rows_view.len) {
        PyErr_SetString(PyExc_ValueError, "rows buffer too small");
        Py_DECREF(res);
        Chain_drop_batch(self);
        return -1;
    }
    self->buf = (const uint8_t *)self->buf_view.buf;
    self->buf_len = self->buf_view.len;
    self->rows = (const int64_t *)self->rows_view.buf;
    self->count = n;
    self->cursor = 0;
    self->my_epoch = (int64_t)epoch;
    Py_INCREF(owner);
    self->buf_obj = owner;
    Py_INCREF(rows);
    self->rows_obj = rows;
    Py_DECREF(res);
    return 1;
}

static PyObject *Chain_next(ChainIter *self) {
    for (;;) {
        if (self->cursor >= self->count || self->epoch[0] != self->my_epoch) {
            const int rc = Chain_refill(self);
            if (rc < 0) return NULL;
            if (rc == 0) {
                PyErr_SetNone(PyExc_StopIteration);
                return NULL;
            }
            continue;
        }
        const int64_t *rec = self->rows + self->cursor * 5;
        const int64_t h = rec[0], s = rec[1], p = rec[2], q = rec[3],
                      e = rec[4];
        if (h < 0 || e > self->buf_len || s < h + 2 || p < s + 1 ||
            q < p + 1 || e < q) {
            PyErr_SetString(PyExc_ValueError, "corrupt offset row");
            return NULL;
        }
        int64_t a = h + 1, b = s - 1;
        while (a < b && WS[self->buf[a]]) ++a;
        while (b > a && WS[self->buf[b - 1]]) --b;

        PyObject *obj;
        if (self->is_view && self->reuse) {
            /* reuse mode: mutate ONE iterator-owned shell in place. Legal
             * under the documented view contract (a view is invalidated by
             * the next parser operation, record.mojo:435-441) — here the
             * "next operation" is the next iteration. Skips the per-record
             * alloc/teardown and owner INCREF/DECREF that dominate the
             * per-object floor (docs/perf_views_floor.md). */
            ViewObj *v = self->reuse_view;
            if (!v) {
                if (self->out_type == ViewTypeExact && view_freelist_n > 0) {
                    v = view_freelist[--view_freelist_n];
                    PyObject_Init((PyObject *)v, ViewTypeExact);
                } else {
                    v = (ViewObj *)self->out_type->tp_alloc(self->out_type,
                                                            0);
                    if (!v) return NULL;
                }
                v->nbufs = 0;  /* freelist shells carry stale fields */
                v->own[0] = v->own[1] = v->own[2] = NULL;
                v->phred_offset = self->phred;
                if (PyObject_IS_GC((PyObject *)v) &&
                    PyObject_GC_IsTracked((PyObject *)v))
                    PyObject_GC_UnTrack((PyObject *)v);
                self->reuse_view = v;  /* iterator's permanent reference */
            }
            v->ptr[0] = self->buf + a;
            v->len[0] = b - a;
            v->ptr[1] = self->buf + s;
            v->len[1] = p - 1 - s;
            v->ptr[2] = self->buf + q;
            v->len[2] = e - q;
            if (v->own[0] != self->buf_obj) {
                Py_INCREF(self->buf_obj);
                Py_XSETREF(v->own[0], self->buf_obj);
            }
            self->cursor++;
            self->progress[0] = (int64_t)self->cursor;
            Py_INCREF((PyObject *)v);
            return (PyObject *)v;
        }
        if (self->is_view) {
            ViewObj *v;
            if (self->out_type == ViewTypeExact && view_freelist_n > 0) {
                v = view_freelist[--view_freelist_n];
                PyObject_Init((PyObject *)v, ViewTypeExact);
            } else {
                v = (ViewObj *)self->out_type->tp_alloc(self->out_type, 0);
                if (!v) return NULL;
            }
            v->nbufs = 0;
            v->phred_offset = self->phred;
            v->ptr[0] = self->buf + a;
            v->len[0] = b - a;
            v->ptr[1] = self->buf + s;
            v->len[1] = p - 1 - s;
            v->ptr[2] = self->buf + q;
            v->len[2] = e - q;
            /* one keep-alive reference suffices: all three spans share the
             * parser window (own[1]/own[2] stay NULL for XDECREF) */
            Py_INCREF(self->buf_obj);
            v->own[0] = self->buf_obj;
            v->own[1] = NULL;
            v->own[2] = NULL;
            obj = (PyObject *)v;
        } else {
            obj = Rec_alloc_fill(self->out_type, self->buf + a, b - a,
                                 self->buf + s, p - 1 - s, self->buf + q,
                                 e - q, self->phred);
            if (!obj) return NULL;
        }
        self->cursor++;
        self->progress[0] = (int64_t)self->cursor;
        /* Python-defined subclasses are GC-tracked heap types; these
         * objects cannot participate in reference cycles (their referents
         * never point back), and tracking millions of short-lived records
         * triggers collector passes mid-iteration. Untrack. */
        if (PyObject_IS_GC(obj) && PyObject_GC_IsTracked(obj))
            PyObject_GC_UnTrack(obj);
        return obj;
    }
}

static PyObject *Chain_iter(PyObject *self) {
    Py_INCREF(self);
    return self;
}

static PyMemberDef Chain_members[] = {
    {"cursor", T_PYSSIZET, offsetof(ChainIter, cursor), READONLY,
     "records served from the current batch snapshot"},
    {NULL},
};

static PyTypeObject ChainIterType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "blazeseq_tpu.native._records.ChainIter",
    .tp_basicsize = sizeof(ChainIter),
    .tp_dealloc = (destructor)Chain_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_iter = Chain_iter,
    .tp_iternext = (iternextfunc)Chain_next,
    .tp_members = Chain_members,
};

/* make_chain_iter(refill, epoch_arr, progress_arr, phred_offset,
 *                 out_type, is_view[, reuse]) */
static PyObject *make_chain_iter(PyObject *mod, PyObject *args) {
    PyObject *refill, *epoch_obj, *progress_obj, *type_obj;
    long phred;
    int is_view;
    int reuse = 0;
    if (!PyArg_ParseTuple(args, "OOOlOp|p", &refill, &epoch_obj,
                          &progress_obj, &phred, &type_obj, &is_view,
                          &reuse))
        return NULL;
    if (reuse && !is_view) {
        PyErr_SetString(PyExc_ValueError,
                        "reuse=True applies to views only (records are "
                        "owned copies)");
        return NULL;
    }
    if (!PyType_Check(type_obj)) {
        PyErr_SetString(PyExc_TypeError, "out_type must be a class");
        return NULL;
    }
    PyTypeObject *tp = (PyTypeObject *)type_obj;
    if (is_view ? !PyType_IsSubtype(tp, &ViewType)
                : !PyType_IsSubtype(tp, &RecType)) {
        PyErr_SetString(PyExc_TypeError,
                        "out_type must subclass the matching C base");
        return NULL;
    }
    ChainIter *it = PyObject_New(ChainIter, &ChainIterType);
    if (!it) return NULL;
    it->refill = NULL;
    it->epoch_obj = NULL;
    it->progress_obj = NULL;
    it->progress_held = 0;
    it->buf_obj = NULL;
    it->rows_obj = NULL;
    it->out_type = NULL;
    it->held = 0;
    it->epoch_held = 0;
    it->exhausted = 0;
    it->count = 0;
    it->cursor = 0;
    it->rows = NULL;
    it->buf = NULL;
    it->phred = phred;
    it->is_view = is_view;
    it->reuse = reuse;
    it->reuse_view = NULL;
    it->my_epoch = -1;  /* forces an initial refill */
    if (PyObject_GetBuffer(epoch_obj, &it->epoch_view, PyBUF_SIMPLE) < 0) {
        Py_DECREF(it);
        return NULL;
    }
    it->epoch_held = 1;
    if (it->epoch_view.len < (Py_ssize_t)sizeof(int64_t)) {
        PyErr_SetString(PyExc_ValueError, "epoch buffer too small");
        Py_DECREF(it);
        return NULL;
    }
    it->epoch = (const int64_t *)it->epoch_view.buf;
    if (PyObject_GetBuffer(progress_obj, &it->progress_view,
                           PyBUF_WRITABLE) < 0) {
        Py_DECREF(it);
        return NULL;
    }
    it->progress_held = 1;
    if (it->progress_view.len < (Py_ssize_t)sizeof(int64_t)) {
        PyErr_SetString(PyExc_ValueError, "progress buffer too small");
        Py_DECREF(it);
        return NULL;
    }
    it->progress = (int64_t *)it->progress_view.buf;
    Py_INCREF(progress_obj);
    it->progress_obj = progress_obj;
    Py_INCREF(refill);
    it->refill = refill;
    Py_INCREF(epoch_obj);
    it->epoch_obj = epoch_obj;
    Py_INCREF(type_obj);
    it->out_type = tp;
    return (PyObject *)it;
}

/* set_helpers(definition_fn, phred_fn, from_string_fn) */
static PyObject *set_helpers(PyObject *mod, PyObject *args) {
    PyObject *d, *p, *f;
    if (!PyArg_ParseTuple(args, "OOO", &d, &p, &f)) return NULL;
    Py_INCREF(d);
    Py_XSETREF(H_definition, d);
    Py_INCREF(p);
    Py_XSETREF(H_phred, p);
    Py_INCREF(f);
    Py_XSETREF(H_from_string, f);
    Py_RETURN_NONE;
}

/* -------- fast trampolines into libblazeseq_scan ------------------------
 * The ctypes bindings cost ~25us per call (pointer wrapper objects, byref
 * cells); at batch granularity (one call per 4K-record window) that is ~10%
 * of the whole parse. These METH_FASTCALL trampolines take the same numpy
 * buffers through the buffer protocol and call the scan library's entry
 * points directly (~1us). Addresses are bound once via bind_scan(). */
typedef int64_t (*soa_fn_t)(const uint8_t *, int64_t, int64_t, int64_t,
                            int64_t, int64_t, int32_t, int32_t, uint8_t,
                            uint8_t, uint8_t *, uint8_t *, int64_t *,
                            uint8_t *, int64_t *, int64_t *, int64_t *,
                            int64_t *, int32_t *, int32_t *);
typedef int64_t (*padded_fn_t)(const uint8_t *, int64_t, int64_t, int64_t,
                               int64_t, int32_t, int32_t, uint8_t, uint8_t,
                               int64_t, uint8_t *, uint8_t *, int32_t *,
                               int64_t *, int32_t *, int32_t *);
static soa_fn_t S_soa = NULL;
static padded_fn_t S_padded = NULL;

static PyObject *bind_scan(PyObject *mod, PyObject *args) {
    unsigned long long a_soa = 0, a_padded = 0;
    if (!PyArg_ParseTuple(args, "KK", &a_soa, &a_padded)) return NULL;
    S_soa = (soa_fn_t)(uintptr_t)a_soa;
    S_padded = (padded_fn_t)(uintptr_t)a_padded;
    Py_RETURN_NONE;
}

/* scan_gather_soa(window, start, max_records, check_ascii, check_quality,
 *                 q_lower, q_upper, seq_out, qual_out, ends_out, id_out,
 *                 id_ends_out) -> (count, total, id_total, consumed,
 *                                  err_code, err_phase) */
static PyObject *soa_fast(PyObject *mod, PyObject *const *a, Py_ssize_t n) {
    if (!S_soa || n != 12) {
        PyErr_SetString(PyExc_TypeError, "bind_scan not called / need 12 args");
        return NULL;
    }
    Py_buffer w, so, qo, eo, io, ieo;
    if (PyObject_GetBuffer(a[0], &w, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(a[7], &so, PyBUF_WRITABLE) < 0) goto e1;
    if (PyObject_GetBuffer(a[8], &qo, PyBUF_WRITABLE) < 0) goto e2;
    if (PyObject_GetBuffer(a[9], &eo, PyBUF_WRITABLE) < 0) goto e3;
    if (PyObject_GetBuffer(a[10], &io, PyBUF_WRITABLE) < 0) goto e4;
    if (PyObject_GetBuffer(a[11], &ieo, PyBUF_WRITABLE) < 0) goto e5;
    {
        int64_t start = PyLong_AsLongLong(a[1]);
        int64_t maxr = PyLong_AsLongLong(a[2]);
        int ca = PyObject_IsTrue(a[3]);
        int cq = PyObject_IsTrue(a[4]);
        long ql = PyLong_AsLong(a[5]);
        long qu = PyLong_AsLong(a[6]);
        int64_t total = 0, id_total = 0, consumed = 0;
        int32_t err = 0, phase = 0;
        int64_t count;
        if (PyErr_Occurred()) goto e6;
        count = S_soa((const uint8_t *)w.buf, (int64_t)w.len, start, maxr,
                      (int64_t)so.len, (int64_t)io.len, ca, cq, (uint8_t)ql,
                      (uint8_t)(qu - ql), (uint8_t *)so.buf,
                      (uint8_t *)qo.buf, (int64_t *)eo.buf,
                      (uint8_t *)io.buf, (int64_t *)ieo.buf, &total,
                      &id_total, &consumed, &err, &phase);
        PyBuffer_Release(&ieo); PyBuffer_Release(&io); PyBuffer_Release(&eo);
        PyBuffer_Release(&qo); PyBuffer_Release(&so); PyBuffer_Release(&w);
        return Py_BuildValue("(LLLLii)", (long long)count, (long long)total,
                             (long long)id_total, (long long)consumed,
                             (int)err, (int)phase);
    }
e6: PyBuffer_Release(&ieo);
e5: PyBuffer_Release(&io);
e4: PyBuffer_Release(&eo);
e3: PyBuffer_Release(&qo);
e2: PyBuffer_Release(&so);
e1: PyBuffer_Release(&w);
    return NULL;
}

/* scan_gather_padded(window, start, max_records, width, check_ascii,
 *                    check_quality, q_lower, q_upper, max_rec_size,
 *                    out_seq, out_qual, out_len)
 *     -> (count, consumed, err_code, err_phase) */
static PyObject *padded_fast(PyObject *mod, PyObject *const *a,
                             Py_ssize_t n) {
    if (!S_padded || n != 12) {
        PyErr_SetString(PyExc_TypeError, "bind_scan not called / need 12 args");
        return NULL;
    }
    Py_buffer w, so, qo, lo;
    if (PyObject_GetBuffer(a[0], &w, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(a[9], &so, PyBUF_WRITABLE) < 0) goto p1;
    if (PyObject_GetBuffer(a[10], &qo, PyBUF_WRITABLE) < 0) goto p2;
    if (PyObject_GetBuffer(a[11], &lo, PyBUF_WRITABLE) < 0) goto p3;
    {
        int64_t start = PyLong_AsLongLong(a[1]);
        int64_t maxr = PyLong_AsLongLong(a[2]);
        int64_t width = PyLong_AsLongLong(a[3]);
        int ca = PyObject_IsTrue(a[4]);
        int cq = PyObject_IsTrue(a[5]);
        long ql = PyLong_AsLong(a[6]);
        long qu = PyLong_AsLong(a[7]);
        int64_t mrs = PyLong_AsLongLong(a[8]);
        int64_t consumed = 0;
        int32_t err = 0, phase = 0;
        int64_t count;
        if (PyErr_Occurred()) goto p4;
        count = S_padded((const uint8_t *)w.buf, (int64_t)w.len, start, maxr,
                         width, ca, cq, (uint8_t)ql, (uint8_t)(qu - ql), mrs,
                         (uint8_t *)so.buf, (uint8_t *)qo.buf,
                         (int32_t *)lo.buf, &consumed, &err, &phase);
        PyBuffer_Release(&lo); PyBuffer_Release(&qo);
        PyBuffer_Release(&so); PyBuffer_Release(&w);
        return Py_BuildValue("(LLii)", (long long)count, (long long)consumed,
                             (int)err, (int)phase);
    }
p4: PyBuffer_Release(&lo);
p3: PyBuffer_Release(&qo);
p2: PyBuffer_Release(&so);
p1: PyBuffer_Release(&w);
    return NULL;
}

static PyMethodDef module_methods[] = {
    {"make_chain_iter", make_chain_iter, METH_VARARGS,
     "C iterator over scanned offset batches producing Record/View objects."},
    {"set_helpers", set_helpers, METH_VARARGS,
     "Register Python helper callables (definition, phred, from_string)."},
    {"bind_scan", bind_scan, METH_VARARGS,
     "Bind libblazeseq_scan entry addresses for the fast trampolines."},
    {"scan_gather_soa", (PyCFunction)soa_fast, METH_FASTCALL,
     "Fast trampoline for bs_scan_gather_soa."},
    {"scan_gather_padded", (PyCFunction)padded_fast, METH_FASTCALL,
     "Fast trampoline for bs_scan_gather_padded."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef records_module = {
    PyModuleDef_HEAD_INIT, "_records",
    "C fast path for record/view iteration", -1, module_methods,
};

PyMODINIT_FUNC PyInit__records(void) {
    init_ws();
    ViewTypeExact = &ViewType;
    RecTypeExact = &RecType;
    if (PyType_Ready(&RecType) < 0) return NULL;
    if (PyType_Ready(&ViewType) < 0) return NULL;
    if (PyType_Ready(&ChainIterType) < 0) return NULL;
    PyObject *m = PyModule_Create(&records_module);
    if (!m) return NULL;
    Py_INCREF(&RecType);
    PyModule_AddObject(m, "Record", (PyObject *)&RecType);
    Py_INCREF(&ViewType);
    PyModule_AddObject(m, "View", (PyObject *)&ViewType);
    return m;
}
