"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``aihab_clip_tpu``, compared by whole top-level name (the
port, ``aihab_clip_tpu_torch``, begins with the JAX package's name); the
reference imports nothing of the port; nothing reads ``bench.py``,
``BENCHMARKS.md`` or ``tools_dev/``."""

import ast
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "aihab_clip_tpu"}


def top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return [p for p in harness.BENCH.rglob("*.py")
            if "tests" not in p.relative_to(harness.BENCH).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tops = top_imports(path)
        assert tops <= {"__future__", "html", "math", "re", "zlib",
                        "functools", "pathlib", "typing", "numpy", "torch"}, \
            (path, tops)


def test_no_source_reads_the_jax_benchmark():
    for path in sources():
        text = path.read_text()
        for name in ("bench.py", "BENCHMARKS.md", "tools_dev"):
            assert name not in text, (path, name)


def test_whole_name_comparison():
    assert harness.forbidden_modules(["aihab_clip_tpu_torch.models",
                                      "numpy", "jaxtyping", "flax_x"]) == []
    assert harness.forbidden_modules(["aihab_clip_tpu.models", "jax._src",
                                      "jaxlib", "flax.linen"]) == [
        "aihab_clip_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_none_of_them():
    """A tiny cell, run to its end in a fresh process, leaves none of the
    forbidden modules in ``sys.modules``."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(harness.BENCH / 'tests')!r})\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from conftest import tiny_config\n"
        "from benchmark import harness\n"
        "cell = harness.cell_of(harness.load_spec(), 'so400m-classify-b64')\n"
        "cell['cfg'] = tiny_config('siglip')\n"
        "cell['traffic'] = dict(cell['traffic'], batch=2, pool_batches=2,"
        " check_rows=2, warmup_batches=1)\n"
        "harness.run_cell(cell, 3, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
