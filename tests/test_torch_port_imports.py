"""Import boundary of the PyTorch port: neither the package nor
chip_smoke.py (nor the port's example and convergence tool) imports JAX or
the JAX package, and chip_smoke.py refuses to run without a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sin_inn_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "examples", "pair_flow_torch.py")
    yield os.path.join(REPO, "tools", "validate_torch.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "sin_inn_tpu")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, REPO)}:{node.lineno} " \
                        f"imports {bad}"


def test_importing_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sin_inn_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'sin_inn_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith(P.__name__)]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 15


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, even where there is one
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=120)


def test_chip_smoke_fails_without_card():
    res = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# the only functions of the port that import imageio: video files that are
# not GIFs (every PNG, GIF and JPEG goes through io/png.py, io/gif.py and
# io/jpeg.py, every resize through io/resize.py; cv2 nowhere)
MEDIA_IMPORTS = {
    ("data/flow_media.py", "load_video_clip"): {"imageio"},
    ("data/prepare.py", "prepare_video"): {"imageio"},
}


def _media_imports(path):
    """{(file, enclosing function or '<module>'): top-level names} of the
    imageio / cv2 / PIL imports in one source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = {}

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module or ""]
            else:
                names = []
            tops = {n.split(".")[0] for n in names} & {"imageio", "cv2",
                                                       "PIL"}
            if tops:
                key = (os.path.relpath(path, PORT), owner)
                found.setdefault(key, set()).update(tops)
            visit(child, owner)

    visit(tree, "<module>")
    return found


def test_imageio_and_cv2_imported_only_for_video_jpeg_and_resizes():
    found = {}
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                found.update(_media_imports(os.path.join(root, f)))
    assert found == MEDIA_IMPORTS


def test_importing_port_loads_no_imageio_cv2_or_pil():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sin_inn_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('imageio', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
