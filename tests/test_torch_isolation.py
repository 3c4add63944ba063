"""The port stands alone: no file of bliss_tpu_torch/ nor chip_smoke.py
imports JAX or the JAX package, the entry points never fall back from the
card to the CPU on their own, and every kernel has its CUDA source."""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "bliss_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "bliss_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_covers_every_package_of_the_port():
    scanned = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in (
        "bliss_tpu_torch/parallel/__init__.py",
        "bliss_tpu_torch/parallel/longsong.py",
        "bliss_tpu_torch/routes.py",
        "bliss_tpu_torch/io/batch.py",
        "bliss_tpu_torch/ops/dft_kernels.py",
        "bliss_tpu_torch/playlist.py",
        "bliss_tpu_torch/library.py",
    ):
        assert rel in scanned
    for init in (REPO / "bliss_tpu_torch").rglob("__init__.py"):
        assert any(p.parent == init.parent and p != init for p in PORT_FILES)


TESTS = REPO / "tests"


def _module_scope_imports(path: pathlib.Path):
    """The modules a file imports at module scope: its top-level statements
    and what they hold, but no function or class body."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(node, ast.Import):
                yield from (alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                yield node.module
            for field in ("body", "orelse", "finalbody", "handlers"):
                yield from walk(getattr(node, field, []))

    yield from walk(ast.parse(path.read_text(), filename=str(path)).body)


def _jax_at_module_scope(path: pathlib.Path, seen=()) -> list:
    """jax/bliss_tpu imports at module scope, also through a test helper
    module of tests/ that the file imports there."""
    bad = []
    for module in _module_scope_imports(path):
        if _forbidden(module):
            bad.append(module)
        elif (TESTS / f"{module}.py").exists() and module not in seen:
            bad += [f"{module} -> {m}" for m in _jax_at_module_scope(TESTS / f"{module}.py", (*seen, module))]
    return bad


def _holds_cuda_marker(path: pathlib.Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute) and node.attr == "cuda":
            if isinstance(node.value, ast.Attribute) and node.value.attr == "mark":
                return True
    return False


CUDA_TEST_FILES = [p for p in sorted(TESTS.glob("test_torch_*.py")) if _holds_cuda_marker(p)]


@pytest.mark.parametrize("path", CUDA_TEST_FILES, ids=lambda p: p.name)
def test_cuda_test_modules_import_no_jax_at_module_scope(path):
    """A test module with `cuda` cases collects on the card's host, which has
    no JAX: it imports `jax` and `bliss_tpu` only inside its JAX
    comparisons (`python3 -m pytest --noconftest -m cuda tests/test_torch_*.py`)."""
    assert not _jax_at_module_scope(path), path.name


def test_module_scope_rule():
    """The scan sees through top-level blocks and a helper module, and not
    into function bodies; the cuda-marked modules are all found."""
    assert _jax_at_module_scope(TESTS / "test_torch_library.py")  # via test_library_ref
    assert not _jax_at_module_scope(TESTS / "test_torch_beat_track.py")
    assert "test_torch_beat_track.py" in {p.name for p in CUDA_TEST_FILES}
    assert len(CUDA_TEST_FILES) >= 9 and not _holds_cuda_marker(TESTS / "test_torch_models.py")


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("bliss_tpu.ops.windows")
    assert not _forbidden("bliss_tpu_torch.ops") and not _forbidden("torch")


#: The only environment the port reads: the reference's config location
#: (XDG folders, src/library.rs:287-326), in library.py.
XDG_READS = {
    'os.environ.get("XDG_CONFIG_HOME")',
    'os.environ.get("XDG_DATA_HOME")',
}


def test_no_environment_switches():
    """No environment variable turns a kernel off or picks a path: the
    only reads of the environment are library.py's XDG folders."""
    for path in PORT_FILES:
        text = path.read_text()
        if path == REPO / "bliss_tpu_torch" / "library.py":
            reads = set(re.findall(r"os\.environ\.get\([^)]*\)", text))
            assert reads == XDG_READS, reads
            text = re.sub(r"os\.environ\.get\(\"XDG_(CONFIG|DATA)_HOME\"\)", "", text)
        assert "environ" not in text and "getenv" not in text, path


def test_no_bliss_variables():
    """No module of the port names an environment variable `BLISS_*`."""
    for path in PORT_FILES:
        assert not re.search(r"[\"']BLISS_", path.read_text()), path


@pytest.mark.parametrize(
    "entry",
    [
        "analyze_samples", "build_analyzer", "analyze_batch", "song",
        "song_with_options", "song_from_path", "analyze_paths", "cue",
        "analyze_paths_batched", "analyze_paths_batched_devices", "make_mesh",
        "sharded_analyze_batch", "library", "library_devices", "example", "bench",
        "scaling_bench",
    ],
)
def test_default_device_raises_without_cuda(monkeypatch, tmp_path, entry):
    from bliss_tpu_torch import AnalysisOptions, Song
    from bliss_tpu_torch.cue import BlissCue
    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.io.decoder import DefaultDecoder
    from bliss_tpu_torch.library import BaseConfig, Library
    from bliss_tpu_torch.models import analyzer as TA
    from bliss_tpu_torch.parallel.mesh import make_mesh, sharded_analyze_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(20000, np.float32)
    wav = REPO / "tests" / "data" / "piano.wav"
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "analyze_samples":
            TA.analyze_samples(x, x.shape[0])
        elif entry == "build_analyzer":
            TA.build_analyzer()(x)
        elif entry == "analyze_batch":
            TA.analyze_batch(x[None], [x.shape[0]])
        elif entry == "song":
            Song.analyze(x)
        elif entry == "song_with_options":
            Song.analyze_with_options(x, AnalysisOptions())
        elif entry == "song_from_path":
            DefaultDecoder.song_from_path(wav)
        elif entry == "analyze_paths":
            DefaultDecoder.analyze_paths([wav])
        elif entry == "cue":
            BlissCue.songs_from_path(DefaultDecoder, REPO / "tests" / "data" / "testcue.cue")
        elif entry == "analyze_paths_batched":
            list(analyze_paths_batched(DefaultDecoder, [wav]))
        elif entry == "analyze_paths_batched_devices":
            list(analyze_paths_batched(DefaultDecoder, [wav], devices=["cuda:0", "cuda:0"]))
        elif entry == "make_mesh":
            make_mesh()
        elif entry == "sharded_analyze_batch":
            sharded_analyze_batch(make_mesh(), x[None], [x.shape[0]])
        elif entry == "example":
            from bliss_tpu_torch.examples import analyze

            analyze.main([str(wav)])
        elif entry == "bench":
            from bliss_tpu_torch.benches import microbench

            microbench.main([])
        elif entry == "scaling_bench":
            from bliss_tpu_torch.benches import scaling_bench

            scaling_bench.main(["--entries", "2"])
        else:
            config = BaseConfig(config_path=tmp_path / "config.json", database_path=tmp_path / "db")
            Library(config, devices=["cuda", "cuda"] if entry == "library_devices" else None)


def test_native_decoder_loads_from_the_port():
    """The port's native decoder is built from its own sources in
    bliss_tpu_torch/io/native/ into bliss_tpu_torch/build/ and loaded by
    that full path, never from bliss_tpu/io/native/."""
    from bliss_tpu_torch.io import _native, decoder

    port = REPO / "bliss_tpu_torch"
    assert _native.NATIVE == port / "io" / "native" and _native.BUILD == port / "build"
    loaded = pathlib.Path(decoder._load_lib()._name)
    assert loaded.is_absolute() and loaded.parent == port / "build", loaded
    assert loaded == _native.decoder_library() and loaded.name.startswith("libbliss_decode-")


def test_every_launch_makes_its_device_current():
    """Every kernel launch of the port goes through `_build.launch`, which
    makes the tensors' device the current one around the call and passes
    that device's stream: no wrapper, bench or test reads a stream or counts
    a launch itself, and each C entry a wrapper looks up is launched by it."""
    text = (REPO / "bliss_tpu_torch" / "ops" / "_build.py").read_text()
    body = text[text.index("def launch(") :]
    body = body[: body.index("\ndef ")]
    assert "with torch.cuda.device(device):" in body and "current_stream(device)" in body
    assert "count_launch(name, device)" in body
    wrappers = [p for p in sorted((REPO / "bliss_tpu_torch" / "ops").glob("*.py")) if p.name != "_build.py"]
    callers = sorted((REPO / "bliss_tpu_torch" / "benches").glob("*.py")) + [REPO / "chip_smoke.py"]
    callers += [p for p in sorted(TESTS.glob("test_torch_*.py")) if p.name != "test_torch_isolation.py"]
    for path in wrappers + callers:
        src = path.read_text()
        for banned in ("stream_ptr", "cuda_stream", "count_launch(", "_build.check("):
            assert banned not in src, (path.name, banned)
    for path in wrappers:
        src = path.read_text()
        assert src.count("_build.function(") == src.count("_build.launch("), path.name
    assert sum(p.read_text().count("_build.launch(") for p in wrappers) == 10


def test_cuda_path_is_f32_only():
    from bliss_tpu_torch.models.analyzer import _resolve_dtype

    assert _resolve_dtype(torch.device("cpu"), None) == torch.float64
    assert _resolve_dtype(torch.device("cuda"), None) == torch.float32
    with pytest.raises(ValueError):
        _resolve_dtype(torch.device("cuda"), torch.float64)


@pytest.mark.parametrize(
    "source,replaces",
    [
        ("timbral_fft.cu", "pallas_dft.py:_make_timbral_fft_kernel"),
        ("specflux.cu", "pallas_dft.py:_make_specflux_kernel"),
        ("ct_stft.cu", "pallas_dft.py:_make_ct_fused_kernel"),
        ("tuning.cu", "pallas_select.py:"),
        ("tuning.cu", "pallas_hist.py:"),
        ("tuning.cu", "pallas_select.py:39 _make_bisect8_kernel"),
        ("tuning.cu", "pallas_hist.py:45 _make_kernel"),
        ("ct_stft.cu", "pallas_dft.py:_make_ct_kernel"),
        ("frame_dft.cu", "pallas_dft.py:53 _make_kernel"),
        ("timbral_flat.cu", "pallas_dft.py:80 _make_timbral_kernel"),
        ("frame_dft.cu", "Bound on the card, frame_dft_mags: bytes"),
        ("timbral_flat.cu", "Bound on the card, timbral_flat: operations"),
        ("tuning.cu", "bisect8_keys"),
        ("tuning.cu", "pallas_select.py:129 _make_bisect16_pair_kernel"),
        ("tuning.cu", "pallas_hist.py:93 _make_threshold_kernel"),
        ("tuning.cu", "tuning_peaks_launch"),
        ("tuning.cu", "tuning_select_launch"),
        ("beat_track.cu", "bliss_tpu/models/tempo.py:760 lax.scan (_bt_do/_checkstate)"),
        ("beat_track.cu", "beat_track_launch"),
        ("autocorr.cu", "bliss_tpu/models/tempo.py:236 _autocorr"),
        ("autocorr.cu", "block_inputs_launch"),
        ("autocorr.cu", "Bound on the card: operations"),
    ],
)
def test_kernel_sources_name_what_they_replace(source, replaces):
    text = (REPO / "bliss_tpu_torch" / "csrc" / source).read_text()
    assert replaces in text
    assert "Bound on the card" in text


def _kernel_body(text: str, name: str) -> str:
    """The text of `__global__` function `name`, up to the next one."""
    start = text.index(f"\n{name}(")
    end = text.find("__global__", start)
    return text[start : end if end > 0 else len(text)]


def test_frame_dft_mags_kernel_is_an_fft():
    """The magnitudes kernel transforms by the warp FFT of fft_common.cuh
    (through the staged tile loop of frame_tiles.cuh) and forms no direct
    DFT product; its note says so. The flat timbral kernel keeps the direct
    product, on the tensor cores: it issues wgmma, six bf16 products a k
    step, and has no SIMT `accumulate(` loop (nor does frame_dft.cu)."""
    csrc = REPO / "bliss_tpu_torch" / "csrc"
    text = (csrc / "frame_dft.cu").read_text()
    body = _kernel_body(text, "frame_dft_mags_kernel")
    assert "bliss::frame_tiles(" in body and "accumulate(" not in body
    assert "using Body = bliss::Rfft512Body;" in text
    assert "warp_rfft512_mags(" in _device_body((csrc / "frame_tiles.cuh").read_text(), "mags")
    flat = (csrc / "timbral_flat.cu").read_text()
    assert "six_products(" in _kernel_body(flat, "timbral_flat_kernel")
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in flat
    six = _device_body(flat, "six_products")
    assert six.count("wgmma_rs(") == 6 and "if (" not in six  # every k step takes all six
    assert "accumulate(" not in flat and "timbral_flat" not in text.replace("timbral_flat.cu", "")
    assert "tf32" not in flat.lower()
    note = text[: text.index("#include")]
    assert "warp_rfft512_mags" in note and "a frame per warp" in note
    assert "warp_rfft512_mags" in (csrc / "fft_common.cuh").read_text()
    for banned in ("cufft", "cub/"):
        assert banned not in text.lower()


def _device_body(text: str, name: str) -> str:
    """The text of device function `name`, from its name to the closing
    brace at the start of a line."""
    start = text.index(f" {name}(")
    return text[start : text.index("\n}", start)]


@pytest.mark.parametrize(
    "source,kernel,epilogue,body",
    [
        ("frame_dft.cu", "frame_dft_mags_kernel", "MagsEpilogue", "Rfft512Body"),
        ("timbral_fft.cu", "timbral_fft_kernel", "TimbralEpilogue", "Radix2Body"),
        ("specflux.cu", "specflux_kernel", "FluxEpilogue", "Rfft512Body"),
    ],
)
def test_strided_frame_kernels_share_the_warp_fft_tile_loop(source, kernel, epilogue, body):
    """The three kernels over 512-sample strided frames are thin
    instantiations of one staged tile loop (frame_tiles.cuh: cp.async tiles,
    double buffered, a frame a warp), each with its own epilogue and a warp
    body: `warp_rfft512_mags` (8 x 8 x 4) for #7 and #2,
    `warp_radix2_512_mags` (a block-wide radix-2 FFT's arithmetic on a warp)
    for #1; both round the windowed samples before the first butterfly. No
    block barrier sits inside a warp transform. Each note keeps its Pallas
    kernel and its bound."""
    csrc = REPO / "bliss_tpu_torch" / "csrc"
    text = (csrc / source).read_text()
    assert "bliss::frame_tiles(" in _kernel_body(text, kernel)
    struct = text[text.index(f"struct {epilogue} {{") :]
    assert f"using Body = bliss::{body};" in struct[: struct.index("};")]
    common = (csrc / "fft_common.cuh").read_text()
    for fn in ("warp_radix2_512_mags", "warp_rfft512_mags"):
        assert "__fmul_rn" in _device_body(common, fn), fn
    assert "fft_radix2_dit(" not in text and "bit_reverse" not in text
    assert '#include "frame_tiles.cuh"' in text
    tiles = (csrc / "frame_tiles.cuh").read_text()
    loop = _device_body(tiles, "frame_tiles")
    assert "body.mags(" in loop and "stage_tile_async<" in loop
    assert "cp_async_wait<1>()" in loop and loop.count("__syncthreads()") == 2
    assert "cp_async<4>(" in _device_body(tiles, "stage_tile_async")
    assert "warp_rfft512_mags(" in tiles and "warp_radix2_512_mags(" in tiles
    for fn in ("warp_fft256", "warp_rfft512_mags", "warp_radix2_512_mags"):
        assert "__syncthreads" not in _device_body(common, fn), fn
    note = " ".join(line.strip("/ ") for line in text[: text.index("#include")].splitlines())
    assert "Bound on the card" in note and "frame_tiles.cuh" in note
    assert "Replaces the TPU kernel" in note or "replaces the TPU kernel" in note
    assert re.search(r"a frame (per|a) warp", note)


def test_ct_stft_8192_body_is_a_block_fft():
    """Both CT entries run `ct8192_kernel`, the source's one kernel:
    radix-16 passes (`dft16`) ending in `last_pass`, no radix-2 stage. The
    note names both Pallas kernels, the bound and the design; the warp core
    of `frame_dft_mags` is the factored `warp_fft256`."""
    csrc = REPO / "bliss_tpu_torch" / "csrc"
    text = (csrc / "ct_stft.cu").read_text()
    body = _kernel_body(text, "ct8192_kernel")
    assert body.count("bliss::dft16(") >= 2 and "last_pass(" in body
    assert "fft_radix2_dit" not in body and text.count("__global__") == 1
    note = text[: text.index("#include")]
    for phrase in ("_make_ct_fused_kernel", "_make_ct_kernel", "Bound on the card: bytes",
                   "671 MB", "16 x 16 x 16", "INTEGER phase"):
        assert phrase in note, phrase
    common = (csrc / "fft_common.cuh").read_text()
    assert "void dft16(" in common
    assert "warp_fft256(re, im, scratch, tw.core, lane);" in common
    for banned in ("cufft", "cub/"):
        assert banned not in text.lower()


def test_radix_counting_pass_is_one_template_with_two_loaders():
    """`bisect8_keys`' counting kernel reads the mask and values through its
    one key loader; the entry has its own C entry point and scan."""
    text = (REPO / "bliss_tpu_torch" / "csrc" / "tuning.cu").read_text()
    for name in ("struct KeyLoader", "count8_kernel(KeyLoader loader", "select8_pair_kernel",
                 'extern "C" int bisect8_keys_launch'):
        assert name in text, name
    assert text.count("Loader {") == 1 and "template <class Loader>" not in text
    assert "cub/" not in text and "thrust" not in text


def test_fused_tuning_route_is_the_peak_list_and_select():
    """#4 and #5 are `tuning_peaks` + `tuning_select`: both C entries, the
    note's bound by the spectrum's bytes, none of the plane kernels they
    replaced, and no library of finished kernels."""
    text = (REPO / "bliss_tpu_torch" / "csrc" / "tuning.cu").read_text()
    for name in ('extern "C" int tuning_peaks_launch', 'extern "C" int tuning_select_launch',
                 "tuning_peaks_kernel", "tuning_select_kernel"):
        assert name in text, name
    note = text[: text.index("#include")]
    assert "the spectrum once" in note
    for gone in ("hist16_kernel", "select16_pair_kernel", "hist_threshold_kernel",
                 "bisect16_pair_launch", "hist_threshold_launch"):
        assert gone not in text, gone
    assert "cub/" not in text and "thrust" not in text


def test_tempo_block_inputs_have_no_toeplitz_gather():
    """The block inputs are the `block_inputs` kernel's wrapper:
    models/tempo.py gathers no Toeplitz matrix and multiplies no matrices,
    and the kernel's autocorrelation sums in XLA's order (8 partials, one
    FMA a term), a thread's 4 lags over one window of 16-byte loads."""
    text = (REPO / "bliss_tpu_torch" / "models" / "tempo.py").read_text()
    assert "toeplitz" not in text.lower() and "matmul" not in text and "@" not in text
    assert "blocks = block_inputs(" in text and "autocorr" not in text
    cu = (REPO / "bliss_tpu_torch" / "csrc" / "autocorr.cu").read_text()
    body = _device_body(cu, "lag_group")
    assert body.count("__fmaf_rn(") == 2 and "__fdiv_rn(" in body and "kPartials = 8" in cu
    assert body.count("load8(") == 4 and "kGroup = 4" in cu
    assert "row_autocorr(" in _kernel_body(cu, "block_inputs_kernel") and cu.count("__global__") == 1


def test_beat_track_step_design():
    """#11's step: block inputs through a cp.async ring in shared memory (no
    register copy of the next block), the phase sum's offsets once a step
    on 21 lanes, one shuffle chain and a ballot for each last maximum."""
    text = (REPO / "bliss_tpu_torch" / "csrc" / "beat_track.cu").read_text()
    body = _kernel_body(text, "beat_track_kernel")
    assert "issue_block(" in body and "cp_async_wait<kStages - 1>()" in body
    assert "nxt" not in body and "load_block" not in text
    assert "__shfl_sync(kFull, my_off, kk)" in body and body.count("last_max(") == 2
    assert "any_nan(" not in text and "last_index_of(" not in text
    assert "__ballot_sync" in _device_body(text, "last_max")


def test_every_kernel_source_is_built():
    from bliss_tpu_torch.ops import _build

    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))


CSRC = REPO / "bliss_tpu_torch" / "csrc"
KERNEL_SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@pytest.mark.parametrize("path", KERNEL_SOURCES, ids=lambda p: p.name)
def test_kernel_sources_build_one_way(path):
    """A kernel source builds the one way the package builds it: no
    preprocessor conditional on a `BLISS_` name that a `-D` could set, and
    no `-D` among the build's flags."""
    from bliss_tpu_torch.ops import _build

    conditionals = re.findall(r"^\s*#\s*(?:if|ifdef|ifndef|elif)\b.*$", path.read_text(), re.M)
    assert not [c for c in conditionals if "BLISS_" in c], conditionals
    assert not [f for f in _build.NVCC_FLAGS if f.startswith("-D")]


C_ENTRIES = sorted(
    (path.name, name)
    for path in sorted(CSRC.glob("*.cu"))
    for name in re.findall(r'extern "C" int (\w+)\(', path.read_text())
)


@pytest.mark.parametrize("source,entry", C_ENTRIES, ids=[e for _, e in C_ENTRIES])
def test_every_entry_point_has_a_wrapper(source, entry):
    """Every C entry of `csrc/` is looked up by a wrapper under `ops/`, by
    its source and name: `_build.function("<source>", "<entry>", ...)`, or
    `_launch_frames("<source>", "<entry>", ...)`, which makes that call. The
    sources hold no entry that no path launches."""
    wrappers = "".join(p.read_text() for p in sorted((REPO / "bliss_tpu_torch" / "ops").glob("*.py")))
    calls = re.findall(r'(_build\.function|_launch_frames)\(\s*"(\w+)",\s*"' + entry + '"', wrappers)
    assert calls, f"{source}: no wrapper looks up {entry}"
    assert {lib for _, lib in calls} == {source[: -len(".cu")]}, calls


def _run_smoke(cwd: pathlib.Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
