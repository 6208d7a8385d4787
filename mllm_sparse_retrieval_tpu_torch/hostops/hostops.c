/* Host-side helpers of the search and live paths (CPython extension), the
 * PyTorch port's copy of the JAX package's hostops/hostops.c.
 *
 * Five functions move per-row interpreter work into C: assembling run
 * dicts (search/runs.make_run), stacking SelectedTerms rows into padded
 * [B, W] query arrays and the fused id-keyed query encode
 * (index/impact.ImpactIndex.encode_query_terms), weighted min-max run
 * fusion (search/fusion.fuse) and the live indexes' per-query segment merge
 * (index/live._merge_rows). Each caller keeps its Python body as the
 * semantic reference and takes it when the input is not list-shaped or
 * the C function refuses it (tests/test_torch_hostops.py holds the two
 * bit-equal).
 *
 * Built at first use by hostops/__init__.py with one g++ call against the
 * running interpreter's headers (no libpython link on Linux).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>

/* build_runs(qids, batch_scores, batch_rankings, remove_query,
 *            scores_sorted) -> run dict
 *
 * Exact semantics of search.runs.make_run: per query a
 * {"docs": {docid: score}, "min_score": m, "max_score": M} entry, with
 * min/max over ALL returned scores BEFORE the optional self-hit
 * removal. All three outer arguments and every row must be lists
 * (what the resolve paths produce via .tolist()); anything else raises
 * TypeError and the caller falls back to the Python path. */
static PyObject *
build_runs(PyObject *self, PyObject *args)
{
    PyObject *qids, *scores_b, *ranks_b;
    int remove_query, scores_sorted;
    if (!PyArg_ParseTuple(args, "O!O!O!pp", &PyList_Type, &qids,
                          &PyList_Type, &scores_b, &PyList_Type, &ranks_b,
                          &remove_query, &scores_sorted))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(qids);
    if (PyList_GET_SIZE(scores_b) < n || PyList_GET_SIZE(ranks_b) < n) {
        PyErr_SetString(PyExc_ValueError, "make_run: length mismatch");
        return NULL;
    }
    PyObject *run = PyDict_New();
    if (!run)
        return NULL;

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *qid = PyList_GET_ITEM(qids, i);        /* borrowed */
        PyObject *scores = PyList_GET_ITEM(scores_b, i);
        PyObject *ranks = PyList_GET_ITEM(ranks_b, i);
        if (!PyList_Check(scores) || !PyList_Check(ranks)) {
            PyErr_SetString(PyExc_TypeError, "make_run: rows must be lists");
            goto fail;
        }
        Py_ssize_t m = PyList_GET_SIZE(scores);
        if (PyList_GET_SIZE(ranks) != m) {
            PyErr_SetString(PyExc_ValueError, "make_run: row length mismatch");
            goto fail;
        }

        PyObject *docs = PyDict_New();
        if (!docs)
            goto fail;
        double mn = 0.0, mx = 0.0;
        for (Py_ssize_t j = 0; j < m; j++) {
            PyObject *k = PyList_GET_ITEM(ranks, j);     /* borrowed */
            PyObject *v = PyList_GET_ITEM(scores, j);    /* borrowed */
            PyObject *ks, *vf;
            if (PyUnicode_Check(k)) {
                ks = k;
                Py_INCREF(ks);
            } else {
                ks = PyObject_Str(k);
                if (!ks) { Py_DECREF(docs); goto fail; }
            }
            if (PyFloat_Check(v)) {
                vf = v;
                Py_INCREF(vf);
            } else {
                vf = PyNumber_Float(v);
                if (!vf) { Py_DECREF(ks); Py_DECREF(docs); goto fail; }
            }
            double dv = PyFloat_AS_DOUBLE(vf);
            if (j == 0) {
                mn = dv;
                mx = dv;
            } else if (scores_sorted) {
                mn = dv;                 /* descending rows: last is min */
            } else {
                if (dv < mn) mn = dv;
                if (dv > mx) mx = dv;
            }
            int rc = PyDict_SetItem(docs, ks, vf);
            Py_DECREF(ks);
            Py_DECREF(vf);
            if (rc < 0) { Py_DECREF(docs); goto fail; }
        }

        PyObject *qid_s;
        if (PyUnicode_Check(qid)) {
            qid_s = qid;
            Py_INCREF(qid_s);
        } else {
            qid_s = PyObject_Str(qid);
            if (!qid_s) { Py_DECREF(docs); goto fail; }
        }
        if (remove_query) {
            int has = PyDict_Contains(docs, qid_s);
            if (has < 0 ||
                (has && PyDict_DelItem(docs, qid_s) < 0)) {
                Py_DECREF(qid_s); Py_DECREF(docs); goto fail;
            }
        }

        PyObject *entry = PyDict_New();
        PyObject *mn_f = PyFloat_FromDouble(mn);
        PyObject *mx_f = PyFloat_FromDouble(mx);
        if (!entry || !mn_f || !mx_f ||
            PyDict_SetItemString(entry, "docs", docs) < 0 ||
            PyDict_SetItemString(entry, "min_score", mn_f) < 0 ||
            PyDict_SetItemString(entry, "max_score", mx_f) < 0 ||
            PyDict_SetItem(run, qid_s, entry) < 0) {
            Py_XDECREF(entry); Py_XDECREF(mn_f); Py_XDECREF(mx_f);
            Py_DECREF(qid_s); Py_DECREF(docs);
            goto fail;
        }
        Py_DECREF(entry);
        Py_DECREF(mn_f);
        Py_DECREF(mx_f);
        Py_DECREF(qid_s);
        Py_DECREF(docs);
    }
    return run;

fail:
    Py_DECREF(run);
    return NULL;
}

/* stack_rows(rows, attr_ids, attr_w, out_ids, out_w) -> bool
 *
 * Fill the writable C-contiguous int32 buffers out_ids/out_w
 * ([B, W] row-major) from rows[i].<attr_ids> / rows[i].<attr_w>.
 * Returns False (leaving the buffers partially written — caller must
 * fall back and overwrite) unless EVERY row attribute exposes a
 * C-contiguous int32 buffer of exactly W elements; the Python caller
 * then uses np.stack. No numpy C API needed: the buffer protocol
 * carries the dtype as format "i". */
static int
copy_rows(PyObject *rows, PyObject *attr, char *dst, Py_ssize_t n,
          Py_ssize_t row_bytes)
{
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *obj = PyObject_GetAttr(PyList_GET_ITEM(rows, i), attr);
        if (!obj)
            return -1;
        Py_buffer view;
        if (PyObject_GetBuffer(obj, &view, PyBUF_FORMAT | PyBUF_ND) < 0) {
            Py_DECREF(obj);
            PyErr_Clear();
            return 0;
        }
        int ok = view.len == row_bytes && view.itemsize == 4 &&
                 view.format && view.format[0] == 'i' &&
                 view.format[1] == '\0' && PyBuffer_IsContiguous(&view, 'C');
        if (ok)
            memcpy(dst + i * row_bytes, view.buf, (size_t)row_bytes);
        PyBuffer_Release(&view);
        Py_DECREF(obj);
        if (!ok)
            return 0;
    }
    return 1;
}

static PyObject *
stack_rows(PyObject *self, PyObject *args)
{
    PyObject *rows, *attr_i, *attr_w;
    Py_buffer out_i, out_w;
    if (!PyArg_ParseTuple(args, "O!UUw*w*", &PyList_Type, &rows,
                          &attr_i, &attr_w, &out_i, &out_w))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(rows);
    int ok = 0;
    if (n > 0 && out_i.len == out_w.len && out_i.len % n == 0) {
        Py_ssize_t row_bytes = out_i.len / n;
        ok = copy_rows(rows, attr_i, (char *)out_i.buf, n, row_bytes);
        if (ok > 0)
            ok = copy_rows(rows, attr_w, (char *)out_w.buf, n, row_bytes);
    }
    PyBuffer_Release(&out_i);
    PyBuffer_Release(&out_w);
    if (ok < 0)
        return NULL;
    return PyBool_FromLong(ok);
}

/* encode_terms(rows, attr_ids, attr_w, lut, width, out_idx, out_w) -> bool
 *
 * Fused id-keyed query encode (ImpactIndex.encode_query_terms, equal-width
 * fast path with no canonical_map): one pass per row maps token id ->
 * compact term idx through the int32 lut (-1 = not indexed), drops
 * out-of-range/OOV/non-positive-weight slots to the dead (0, 0.0) padding
 * pair, and zero-fills the [width, q_m) pad columns. Replaces stack_rows +
 * the numpy lut gather + two np.where passes + two np.zeros allocations —
 * the encode is GIL-serialized with the serving dispatch loop, so every
 * millisecond here is pipeline headroom. Returns False (caller falls back,
 * buffers may be partially written) unless every row attribute exposes a
 * C-contiguous int32 buffer of exactly `width` elements. */
static PyObject *
encode_terms(PyObject *self, PyObject *args)
{
    PyObject *rows, *attr_i, *attr_w;
    Py_buffer lut, out_i, out_w;
    Py_ssize_t width;
    if (!PyArg_ParseTuple(args, "O!UUy*nw*w*", &PyList_Type, &rows,
                          &attr_i, &attr_w, &lut, &width, &out_i, &out_w))
        return NULL;
    Py_ssize_t b = PyList_GET_SIZE(rows);
    int ok = 0;
    if (b > 0 && width > 0 && lut.len % 4 == 0 &&
        out_i.len == out_w.len && out_i.len % (Py_ssize_t)(4 * b) == 0) {
        Py_ssize_t q_m = out_i.len / (4 * b);
        const int32_t *lut_p = (const int32_t *)lut.buf;
        Py_ssize_t vocab = lut.len / 4;
        ok = (q_m >= width);
        for (Py_ssize_t i = 0; ok && i < b; i++) {
            PyObject *row = PyList_GET_ITEM(rows, i);
            PyObject *ids_o = PyObject_GetAttr(row, attr_i);
            if (!ids_o) { ok = -1; break; }
            PyObject *w_o = PyObject_GetAttr(row, attr_w);
            if (!w_o) { Py_DECREF(ids_o); ok = -1; break; }
            Py_buffer ids_v, w_v;
            if (PyObject_GetBuffer(ids_o, &ids_v,
                                   PyBUF_FORMAT | PyBUF_ND) < 0) {
                PyErr_Clear(); Py_DECREF(ids_o); Py_DECREF(w_o);
                ok = 0; break;
            }
            if (PyObject_GetBuffer(w_o, &w_v, PyBUF_FORMAT | PyBUF_ND) < 0) {
                PyErr_Clear(); PyBuffer_Release(&ids_v);
                Py_DECREF(ids_o); Py_DECREF(w_o);
                ok = 0; break;
            }
            ok = ids_v.len == width * 4 && w_v.len == width * 4 &&
                 ids_v.itemsize == 4 && w_v.itemsize == 4 &&
                 ids_v.format && ids_v.format[0] == 'i' &&
                 ids_v.format[1] == '\0' &&
                 w_v.format && w_v.format[0] == 'i' &&
                 w_v.format[1] == '\0' &&
                 PyBuffer_IsContiguous(&ids_v, 'C') &&
                 PyBuffer_IsContiguous(&w_v, 'C');
            if (ok) {
                const int32_t *tp = (const int32_t *)ids_v.buf;
                const int32_t *wp = (const int32_t *)w_v.buf;
                int32_t *oi = (int32_t *)out_i.buf + i * q_m;
                float *ow = (float *)out_w.buf + i * q_m;
                for (Py_ssize_t j = 0; j < width; j++) {
                    int32_t t = tp[j], wv = wp[j];
                    int32_t idx = (t >= 0 && t < vocab) ? lut_p[t] : -1;
                    int live = idx >= 0 && wv > 0;
                    oi[j] = live ? idx : 0;
                    ow[j] = live ? (float)wv : 0.0f;
                }
                memset(oi + width, 0, (size_t)(q_m - width) * 4);
                memset(ow + width, 0, (size_t)(q_m - width) * 4);
            }
            PyBuffer_Release(&ids_v);
            PyBuffer_Release(&w_v);
            Py_DECREF(ids_o);
            Py_DECREF(w_o);
        }
    }
    PyBuffer_Release(&lut);
    PyBuffer_Release(&out_i);
    PyBuffer_Release(&out_w);
    if (ok < 0)
        return NULL;
    return PyBool_FromLong(ok);
}

/* fuse_runs(runs, weights) -> {qid: {doc: fused}}
 *
 * Exact semantics (and accumulation ORDER — the doubles must stay
 * bit-identical) of search.fusion.fuse: per query, per doc,
 * sum_i weight_i * (score_i - min_i) / max(max_i - min_i, 1e-9) over the
 * runs that contain (qid, doc); a qid or doc missing from a run
 * contributes 0. `runs` is a list of {qid: {"docs": {...}, "min_score": m,
 * "max_score": M}} dicts, `weights` a list of floats. Any shape surprise
 * raises (TypeError/KeyError); the Python caller falls back. */
static PyObject *
fuse_runs(PyObject *self, PyObject *args)
{
    PyObject *runs, *weights;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &runs,
                          &PyList_Type, &weights))
        return NULL;
    Py_ssize_t n_runs = PyList_GET_SIZE(runs);
    if (PyList_GET_SIZE(weights) < n_runs) {
        PyErr_SetString(PyExc_ValueError, "fuse: weights shorter than runs");
        return NULL;
    }
    double *w = (double *)PyMem_Malloc((size_t)(n_runs ? n_runs : 1) *
                                       3 * sizeof(double));
    PyObject **docs_i = (PyObject **)
        PyMem_Malloc((size_t)(n_runs ? n_runs : 1) * sizeof(PyObject *));
    if (!w || !docs_i) {
        PyMem_Free(w); PyMem_Free(docs_i);
        return PyErr_NoMemory();
    }
    double *lo = w + n_runs, *denom = w + 2 * n_runs;
    PyObject *fused = NULL;
    for (Py_ssize_t i = 0; i < n_runs; i++) {
        w[i] = PyFloat_AsDouble(PyList_GET_ITEM(weights, i));
        if (w[i] == -1.0 && PyErr_Occurred())
            goto fail;
        if (!PyDict_Check(PyList_GET_ITEM(runs, i))) {
            PyErr_SetString(PyExc_TypeError, "fuse: runs must be dicts");
            goto fail;
        }
    }
    fused = PyDict_New();
    if (!fused)
        goto fail;

    /* Union of qids in run order (doc/qid insertion order then matches the
     * reference's per-run iteration; values are order-independent). */
    for (Py_ssize_t r = 0; r < n_runs; r++) {
        PyObject *run = PyList_GET_ITEM(runs, r);
        PyObject *qid, *entry;
        Py_ssize_t pos = 0;
        while (PyDict_Next(run, &pos, &qid, &entry)) {
            if (PyDict_Contains(fused, qid))
                continue;
            /* per-run (docs, lo, denom) for this qid */
            for (Py_ssize_t i = 0; i < n_runs; i++) {
                PyObject *e = PyDict_GetItem(PyList_GET_ITEM(runs, i), qid);
                docs_i[i] = NULL;
                if (!e)
                    continue;
                if (!PyDict_Check(e)) {
                    PyErr_SetString(PyExc_TypeError,
                                    "fuse: run entries must be dicts");
                    goto fail;
                }
                PyObject *docs = PyDict_GetItemString(e, "docs");
                PyObject *mn = PyDict_GetItemString(e, "min_score");
                PyObject *mx = PyDict_GetItemString(e, "max_score");
                if (!docs || !PyDict_Check(docs) || !mn || !mx) {
                    PyErr_SetString(PyExc_TypeError,
                                    "fuse: entry missing docs/min/max");
                    goto fail;
                }
                double lo_v = PyFloat_AsDouble(mn);
                double hi_v = PyFloat_AsDouble(mx);
                if (PyErr_Occurred())
                    goto fail;
                double d = hi_v - lo_v;
                docs_i[i] = docs;
                lo[i] = lo_v;
                denom[i] = d > 1e-9 ? d : 1e-9;
            }
            PyObject *out_docs = PyDict_New();
            if (!out_docs || PyDict_SetItem(fused, qid, out_docs) < 0) {
                Py_XDECREF(out_docs);
                goto fail;
            }
            for (Py_ssize_t i = 0; i < n_runs; i++) {
                if (!docs_i[i])
                    continue;
                PyObject *doc, *sv;
                Py_ssize_t dpos = 0;
                while (PyDict_Next(docs_i[i], &dpos, &doc, &sv)) {
                    int has = PyDict_Contains(out_docs, doc);
                    if (has < 0) { Py_DECREF(out_docs); goto fail; }
                    if (has)
                        continue;
                    double score = 0.0;
                    for (Py_ssize_t j = 0; j < n_runs; j++) {
                        if (!docs_i[j])
                            continue;
                        PyObject *s = PyDict_GetItem(docs_i[j], doc);
                        if (!s)
                            continue;
                        double sd = PyFloat_AsDouble(s);
                        if (sd == -1.0 && PyErr_Occurred()) {
                            Py_DECREF(out_docs);
                            goto fail;
                        }
                        score += w[j] * ((sd - lo[j]) / denom[j]);
                    }
                    PyObject *sf = PyFloat_FromDouble(score);
                    int rc = sf ? PyDict_SetItem(out_docs, doc, sf) : -1;
                    Py_XDECREF(sf);
                    if (rc < 0) { Py_DECREF(out_docs); goto fail; }
                }
            }
            Py_DECREF(out_docs);
        }
    }
    PyMem_Free(w);
    PyMem_Free(docs_i);
    return fused;

fail:
    PyMem_Free(w);
    PyMem_Free(docs_i);
    Py_XDECREF(fused);
    return NULL;
}

/* merge_topk_rows(seg_scores, seg_ids, tombstones, drop_pad, pad_id,
 *                 depth) -> (score_rows, id_rows)
 *
 * Exact semantics of index.live._merge_rows: per query, candidates
 * concatenate in segment order (skipping tombstoned ids and, for
 * segments with drop_pad true, the reserved pad id), stable-sort by
 * descending score (ties keep insertion order -> older segment first),
 * truncate to depth. This is the live-serving host merge — per-candidate
 * Python loops here serialize with the device pipeline.
 *
 * seg_scores/seg_ids: lists (one per segment) of lists (one per query)
 * of lists; tombstones: list of sets; drop_pad: list of ints. Shape
 * surprises raise and the Python caller falls back. */
typedef struct {
    double score;
    Py_ssize_t ord;
    PyObject *id;        /* borrowed */
} Cand;

static int
cand_cmp(const void *a, const void *b)
{
    const Cand *x = (const Cand *)a, *y = (const Cand *)b;
    if (x->score > y->score) return -1;
    if (x->score < y->score) return 1;
    return (x->ord < y->ord) ? -1 : 1;   /* stable: insertion order */
}

static PyObject *
merge_topk_rows(PyObject *self, PyObject *args)
{
    PyObject *seg_scores, *seg_ids, *tombs, *drop_pad, *pad_id;
    Py_ssize_t depth;
    if (!PyArg_ParseTuple(args, "O!O!O!O!On", &PyList_Type, &seg_scores,
                          &PyList_Type, &seg_ids, &PyList_Type, &tombs,
                          &PyList_Type, &drop_pad, &pad_id, &depth))
        return NULL;
    Py_ssize_t n_seg = PyList_GET_SIZE(seg_scores);
    if (PyList_GET_SIZE(seg_ids) != n_seg ||
        PyList_GET_SIZE(tombs) != n_seg ||
        PyList_GET_SIZE(drop_pad) != n_seg || n_seg == 0) {
        PyErr_SetString(PyExc_ValueError, "merge: segment arity mismatch");
        return NULL;
    }
    PyObject *first = PyList_GET_ITEM(seg_scores, 0);
    if (!PyList_Check(first)) {
        PyErr_SetString(PyExc_TypeError, "merge: rows must be lists");
        return NULL;
    }
    Py_ssize_t b = PyList_GET_SIZE(first);
    PyObject *out_s = PyList_New(b);
    PyObject *out_i = PyList_New(b);
    Cand *cands = NULL;
    Py_ssize_t cap = 0;
    if (!out_s || !out_i)
        goto fail;

    for (Py_ssize_t q = 0; q < b; q++) {
        Py_ssize_t n_cand = 0;
        for (Py_ssize_t s = 0; s < n_seg; s++) {
            PyObject *sc_rows = PyList_GET_ITEM(seg_scores, s);
            PyObject *id_rows = PyList_GET_ITEM(seg_ids, s);
            if (!PyList_Check(sc_rows) || !PyList_Check(id_rows) ||
                PyList_GET_SIZE(sc_rows) <= q ||
                PyList_GET_SIZE(id_rows) <= q) {
                PyErr_SetString(PyExc_ValueError, "merge: short segment");
                goto fail;
            }
            PyObject *srow = PyList_GET_ITEM(sc_rows, q);
            PyObject *irow = PyList_GET_ITEM(id_rows, q);
            if (!PyList_Check(srow) || !PyList_Check(irow)) {
                PyErr_SetString(PyExc_TypeError, "merge: rows must be lists");
                goto fail;
            }
            PyObject *tomb = PyList_GET_ITEM(tombs, s);
            long pad = PyLong_AsLong(PyList_GET_ITEM(drop_pad, s));
            if (pad < 0 && PyErr_Occurred())
                goto fail;
            Py_ssize_t m = PyList_GET_SIZE(srow);
            if (PyList_GET_SIZE(irow) < m)
                m = PyList_GET_SIZE(irow);
            if (n_cand + m > cap) {
                cap = (n_cand + m) * 2 + 16;
                Cand *grown = (Cand *)PyMem_Realloc(cands,
                                                    cap * sizeof(Cand));
                if (!grown) {
                    PyErr_NoMemory();
                    goto fail;
                }
                cands = grown;
            }
            for (Py_ssize_t j = 0; j < m; j++) {
                PyObject *doc = PyList_GET_ITEM(irow, j);
                int dead = PySet_Contains(tomb, doc);
                if (dead < 0)
                    goto fail;
                if (!dead && pad) {
                    dead = PyObject_RichCompareBool(doc, pad_id, Py_EQ);
                    if (dead < 0)
                        goto fail;
                }
                if (dead)
                    continue;
                double sc = PyFloat_AsDouble(PyList_GET_ITEM(srow, j));
                if (sc == -1.0 && PyErr_Occurred())
                    goto fail;
                cands[n_cand].score = sc;
                cands[n_cand].ord = n_cand;
                cands[n_cand].id = doc;
                n_cand++;
            }
        }
        qsort(cands, (size_t)n_cand, sizeof(Cand), cand_cmp);
        Py_ssize_t take = n_cand < depth ? n_cand : depth;
        PyObject *row_s = PyList_New(take);
        PyObject *row_i = PyList_New(take);
        if (!row_s || !row_i) {
            Py_XDECREF(row_s);
            Py_XDECREF(row_i);
            goto fail;
        }
        for (Py_ssize_t j = 0; j < take; j++) {
            PyObject *f = PyFloat_FromDouble(cands[j].score);
            if (!f) {
                Py_DECREF(row_s);
                Py_DECREF(row_i);
                goto fail;
            }
            PyList_SET_ITEM(row_s, j, f);
            Py_INCREF(cands[j].id);
            PyList_SET_ITEM(row_i, j, cands[j].id);
        }
        PyList_SET_ITEM(out_s, q, row_s);
        PyList_SET_ITEM(out_i, q, row_i);
    }
    PyMem_Free(cands);
    return Py_BuildValue("NN", out_s, out_i);
fail:
    PyMem_Free(cands);
    Py_XDECREF(out_s);
    Py_XDECREF(out_i);
    return NULL;
}

static PyMethodDef methods[] = {
    {"build_runs", build_runs, METH_VARARGS,
     "Assemble a run dict (make_run semantics) at C speed."},
    {"merge_topk_rows", merge_topk_rows, METH_VARARGS,
     "Per-query stable descending merge of per-segment top-k rows."},
    {"stack_rows", stack_rows, METH_VARARGS,
     "Fill [B, W] int32 buffers from per-row array attributes."},
    {"encode_terms", encode_terms, METH_VARARGS,
     "Fused id-keyed query encode into padded [B, q_m] (idx, weight)."},
    {"fuse_runs", fuse_runs, METH_VARARGS,
     "Weighted min-max run fusion (search.fusion.fuse semantics)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "mllm_torch_hostops",
    "Host-side serving-path accelerators.", -1, methods,
};

PyMODINIT_FUNC
PyInit_mllm_torch_hostops(void)
{
    return PyModule_Create(&module);
}
