"""The port's own copies of the JAX package's framework-free host modules.

Each copy stays byte for byte as its original, so a fix to either shows
up here until the other carries it too, with two named exceptions:

* where an original cites the reference implementation's sources by the
  absolute path of a checkout, the copy gives the path relative to it
  (``reference/src/...``; ``relative_reference_paths``);
* ``native.py`` differs in the lines named by ``NATIVE_EDITS``: the port
  builds its own copy of the C++ source, with the ``.rpa`` fragment pass
  that includes it (``csrc/host/fragment_pass.cpp``), into its own build
  directory, through a temporary file, parses a columnar dump in one
  function that the flat pass shares (``columnar_fragments``), and counts
  the rows its output composer writes (``outputs.composed_rows``,
  :mod:`rpvg_tpu_torch.spans`).

No file of the port imports the JAX package."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "rpvg_tpu")
PORT_DIR = os.path.join(REPO, "rpvg_tpu_torch")

COPIED_MODULES = [
    "constants", "hostalloc", "mathutils", "scoring", "alignments",
    "io/__init__", "io/bgzf", "io/vgproto", "io/sdsl", "io/gam", "io/xg_file",
    "io/gbwt_file", "graph", "fragments", "pathindex", "projection",
    "probabilities", "native", "clustering", "infer/mincover",
    "infer/estimates", "infer/matrices", "io/info", "io/json_stream", "io/rpa",
    "io/writers", "sim", "tools",
]

# (original lines, the port's lines): the only differences of native.py.
NATIVE_EDITS = [
    (
        '_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")\n'
        '_SRC = os.path.join(_NATIVE_DIR, "rpvg_native.cpp")\n'
        '_LIB = os.path.join(_NATIVE_DIR, "librpvg_native.so")\n',
        '_PKG_DIR = os.path.dirname(os.path.abspath(__file__))\n'
        '_SRC = os.path.join(_PKG_DIR, "csrc", "host", "rpvg_native.cpp")\n'
        "# The library's translation unit: rpvg_native.cpp and the `.rpa` fragment\n"
        "# pass that includes it (fragment_pass.py).\n"
        '_TU = os.path.join(_PKG_DIR, "csrc", "host", "fragment_pass.cpp")\n'
        '_LIB = os.path.join(_PKG_DIR, "build", "host", "librpvg_native.so")\n',
    ),
    (
        "def _build_library() -> bool:\n"
        "    cmd = [\n",
        "def _build_library() -> bool:\n"
        "    # Several processes may build at once: each writes its own temporary\n"
        "    # file and renames it into place, so none loads a half-written library.\n"
        "    os.makedirs(os.path.dirname(_LIB), exist_ok=True)\n"
        '    tmp = f"{_LIB}.{os.getpid()}.tmp"\n'
        "    cmd = [\n",
    ),
    (
        "        _SRC, \"-o\", _LIB,\n",
        "        _TU, \"-o\", tmp,\n",
    ),
    (
        "    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):\n",
        "    newest = max(os.path.getmtime(_SRC), os.path.getmtime(_TU))\n"
        "    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < newest:\n",
    ),
    (
        "        return False\n"
        "    return True\n",
        "        return False\n"
        "    os.replace(tmp, _LIB)\n"
        "    return True\n",
    ),
    (
        "        try:\n"
        "            data = ctypes.string_at(out_ptr, out_len.value)\n"
        "        finally:\n"
        "            self._lib.rpvg_buffer_free(out_ptr)\n"
        "\n"
        '        (n,) = struct.unpack_from("<Q", data, 0)\n'
        "        offset = 8\n"
        "        counts = np.frombuffer(data, dtype=np.uint64, count=n, offset=offset)\n"
        "        offset += 8 * n\n"
        "        anchors = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)\n"
        "        offset += 8 * n\n"
        "        n_ids = np.frombuffer(data, dtype=np.int32, count=n, offset=offset)\n"
        "        offset += 4 * n\n"
        '        (ids_total,) = struct.unpack_from("<q", data, offset)\n'
        "        offset += 8\n"
        "        all_ids = np.frombuffer(data, dtype=np.int64, count=ids_total, offset=offset)\n"
        "        offset += 8 * ids_total\n"
        "        raw_lens = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)\n"
        "        offset += 8 * n\n"
        "\n"
        "        id_bounds = np.zeros(n + 1, dtype=np.int64)\n"
        "        np.cumsum(n_ids, out=id_bounds[1:])\n"
        "        raw_bounds = np.full(n + 1, offset, dtype=np.int64)\n"
        "        np.cumsum(raw_lens, out=raw_bounds[1:])\n"
        "        raw_bounds[1:] += offset\n"
        "        offset = int(raw_bounds[-1])\n"
        "\n"
        '        (unaligned,) = struct.unpack_from("<Q", data, offset)\n'
        "        offset += 8\n"
        "        histogram = np.frombuffer(data, dtype=np.int64, count=hist_size, offset=offset).copy()\n"
        "        cols = ColumnarFragments(\n"
        "            data, counts, anchors, id_bounds, all_ids, raw_bounds,\n"
        "            histogram, int(unaligned),\n"
        "        )\n"
        "        cols.n_threads = int(self._iparams[7])\n"
        "        return cols\n",
        "        try:\n"
        "            data = ctypes.string_at(out_ptr, out_len.value)\n"
        "        finally:\n"
        "            self._lib.rpvg_buffer_free(out_ptr)\n"
        "        cols = columnar_fragments(data, hist_size)\n"
        "        cols.n_threads = int(self._iparams[7])\n"
        "        return cols\n",
    ),
    (
        "def _parse_path_list(view, offset):\n",
        "def columnar_fragments(data: bytes, hist_size: int) -> ColumnarFragments:\n"
        '    """:class:`ColumnarFragments` over a dump in the layout of\n'
        '    ``rpvg_indexer_dump_located`` (also ``rpvg_flat_dump``\'s)."""\n'
        '    (n,) = struct.unpack_from("<Q", data, 0)\n'
        "    offset = 8\n"
        "    counts = np.frombuffer(data, dtype=np.uint64, count=n, offset=offset)\n"
        "    offset += 8 * n\n"
        "    anchors = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)\n"
        "    offset += 8 * n\n"
        "    n_ids = np.frombuffer(data, dtype=np.int32, count=n, offset=offset)\n"
        "    offset += 4 * n\n"
        '    (ids_total,) = struct.unpack_from("<q", data, offset)\n'
        "    offset += 8\n"
        "    all_ids = np.frombuffer(data, dtype=np.int64, count=ids_total, offset=offset)\n"
        "    offset += 8 * ids_total\n"
        "    raw_lens = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)\n"
        "    offset += 8 * n\n"
        "\n"
        "    id_bounds = np.zeros(n + 1, dtype=np.int64)\n"
        "    np.cumsum(n_ids, out=id_bounds[1:])\n"
        "    raw_bounds = np.full(n + 1, offset, dtype=np.int64)\n"
        "    np.cumsum(raw_lens, out=raw_bounds[1:])\n"
        "    raw_bounds[1:] += offset\n"
        "    offset = int(raw_bounds[-1])\n"
        "\n"
        '    (unaligned,) = struct.unpack_from("<Q", data, offset)\n'
        "    offset += 8\n"
        "    histogram = np.frombuffer(data, dtype=np.int64, count=hist_size, offset=offset).copy()\n"
        "    return ColumnarFragments(\n"
        "        data, counts, anchors, id_bounds, all_ids, raw_bounds,\n"
        "        histogram, int(unaligned),\n"
        "    )\n"
        "\n"
        "\n"
        "def _parse_path_list(view, offset):\n",
    ),
    (
        "        lib.rpvg_buffer_free(out_joint)\n"
        "    return hap_text, joint_text\n",
        "        lib.rpvg_buffer_free(out_joint)\n"
        "    from rpvg_tpu_torch import spans\n"
        "\n"
        '    spans.count("outputs.composed_rows", hap_text.count("\\n") + joint_text.count("\\n"))\n'
        "    return hap_text, joint_text\n",
    ),
]


def _read(path):
    with open(path, "rb") as handle:
        return handle.read()


def relative_reference_paths(text):
    """``/<dir>/reference/`` (an absolute checkout path) as ``reference/``."""
    return re.sub(r"(?<![\w.])/[a-z]+/reference/", "reference/", text)


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_host_copy_has_not_drifted(module):
    original = relative_reference_paths(_read(os.path.join(REF_DIR, module + ".py")).decode())
    copy = _read(os.path.join(PORT_DIR, module + ".py")).decode()
    if module == "native":
        for old, new in NATIVE_EDITS:
            assert original.count(old) == 1, old
            original = original.replace(old, new)
    assert copy == original


def test_native_source_copy_has_not_drifted():
    original = _read(os.path.join(REPO, "native", "rpvg_native.cpp")).decode()
    copy = _read(os.path.join(PORT_DIR, "csrc", "host", "rpvg_native.cpp")).decode()
    assert copy == relative_reference_paths(original)


def test_port_builds_its_own_native_library():
    from rpvg_tpu_torch import native

    assert native._SRC.startswith(PORT_DIR + os.sep)
    assert native._LIB.startswith(os.path.join(PORT_DIR, "build") + os.sep)


def test_no_file_of_the_port_imports_the_jax_package():
    pattern = re.compile(r"^\s*(import|from) (rpvg_tpu|jax)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [path for path in files if pattern.search(_read(path).decode())]
    assert len(files) > 40 and not offenders, offenders
    for new in ("parallel/autoshard.py", "parallel/mesh.py", "entry.py"):
        assert os.path.join(PORT_DIR, *new.split("/")) in files
