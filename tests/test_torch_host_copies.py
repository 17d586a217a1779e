"""The port's own copies of the JAX package's framework-free host modules.

Each copy stays byte for byte as its original, so a fix to either shows
up here until the other carries it too, with two named exceptions:

* where an original cites the reference implementation's sources by the
  absolute path of a checkout, the copy gives the path relative to it
  (``reference/src/...``; ``relative_reference_paths``);
* ``native.py`` differs in the lines named by ``NATIVE_EDITS``: the port
  builds its own copy of the C++ source into its own build directory,
  through a temporary file.

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
        "        _SRC, \"-o\", tmp,\n",
    ),
    (
        "        return False\n"
        "    return True\n",
        "        return False\n"
        "    os.replace(tmp, _LIB)\n"
        "    return True\n",
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
