"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name; the reference loads nothing of the program."""

import os
import subprocess
import sys
import textwrap

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def modules_after(code: str) -> set:
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{ROOT!r}, {BENCH!r}]
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print(sorted({{m.split('.')[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = modules_after("""
        import torch, run
        from harness import manifest
        name = manifest.load_manifest()["workloads"][0]["name"]
        cell = manifest.resolve(name)
        cell.mix.update(batch_size=2, points=64, epoch_steps=1)
        run.execute(name, 7, 0.2, True, torch.device("cpu"), cell)
        import harness.rooms_driver, harness.train_driver
        assert not run.forbidden_modules()
    """)
    assert "weaksuppointcloudseg_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "weaksuppointcloudseg_tpu"}
    assert not loaded & {"bench", "chip_smoke"}


def test_reference_loads_nothing_of_the_program():
    loaded = modules_after("""
        import reference.dgcnn, reference.train, reference.rooms, reference.precision
    """)
    assert not loaded & {"weaksuppointcloudseg_tpu_torch", "weaksuppointcloudseg_tpu",
                         "jax", "jaxlib", "flax", "harness"}


def test_forbidden_names_compared_whole():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["weaksuppointcloudseg_tpu_torch_like"] = sys
        assert "weaksuppointcloudseg_tpu" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
