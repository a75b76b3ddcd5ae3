"""Rules the port's kernels keep, checked on the CPU from their sources and
wrappers: the port's attention is its own kernel (no module calls a
library's fused attention, ``torch.compile`` or cuDNN, and the CUDA sources
include no library kernel), and the wgmma variants' operands are checked
for what their TMA loads need before any launch."""
import ast
import re
from pathlib import Path

import pytest
import torch

from detectmateservice_tpu_torch.ops import flash

PACKAGE = Path(__file__).resolve().parents[1] / "detectmateservice_tpu_torch"
PY_MODULES = sorted(PACKAGE.rglob("*.py"))
CUDA_SOURCES = sorted((PACKAGE / "ops" / "csrc").glob("*.cu*"))

# names whose use hands attention (or a whole graph) to a library kernel
_LIBRARY_NAMES = re.compile(
    r"scaled_dot_product|sdpa|SDPBackend|cudnn|flash_attn|efficient_attention",
    re.IGNORECASE)
# headers of ready-made kernels: cuDNN, cuBLAS, CUTLASS's device-level GEMMs
_LIBRARY_INCLUDES = re.compile(
    r"#\s*include\s*[<\"](cudnn|cublas|cutlass/gemm/device|cutlass/gemm/kernel|"
    r"flash)", re.IGNORECASE)


def _library_uses(tree: ast.AST) -> list:
    """(line, name) of every name, attribute or import in ``tree`` that
    reaches a library attention kernel, cuDNN or ``torch.compile``."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names = [node.id]
        elif isinstance(node, ast.Attribute):
            names = [node.attr]
            if node.attr == "compile" and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                found.append((node.lineno, "torch.compile"))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [alias.name for alias in node.names]
            if isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
        else:
            continue
        found.extend((node.lineno, n) for n in names if _LIBRARY_NAMES.search(n))
    return found


def test_the_scan_covers_the_package():
    assert len(PY_MODULES) > 10
    assert {p.name for p in CUDA_SOURCES} >= {"flash.cu", "scorehead.cu"}


@pytest.mark.parametrize("path", PY_MODULES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_module_calls_a_library_attention_kernel(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert _library_uses(tree) == []


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_include_no_library_kernel(path):
    assert _LIBRARY_INCLUDES.findall(path.read_text()) == []


@pytest.mark.parametrize("snippet, hit", [
    ("import torch.nn.functional as F\nF.scaled_dot_product_attention(q, k, v)",
     "scaled_dot_product_attention"),
    ("import torch\nf = torch.compile(g)", "torch.compile"),
    ("import torch\ntorch.backends.cudnn.enabled = True", "cudnn"),
    ("from torch.nn.attention import sdpa_kernel, SDPBackend", "sdpa_kernel"),
])
def test_the_scan_finds_library_calls(snippet, hit):
    assert hit in {name for _, name in _library_uses(ast.parse(snippet))}


def test_the_include_scan_finds_library_headers():
    text = "#include <cutlass/gemm/device/gemm.h>\n#include <cudnn.h>\n#include <cuda.h>\n"
    assert len(_LIBRARY_INCLUDES.findall(text)) == 2


# -- TMA alignment of the wgmma variants' operands --------------------------
def _qkv_views(b=2, s=10, h=4, d=64, dtype=torch.bfloat16):
    """q, k, v as models/logbert.py cuts them from one [B, S, 3 H D] tensor."""
    qkv = torch.zeros(b, s, 3 * h * d, dtype=dtype)
    return [x.reshape(b, s, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize("make", [
    lambda: [torch.zeros(2, 3, 10, 64, dtype=torch.bfloat16)],
    lambda: [torch.zeros(2, 3, 10, 128, dtype=torch.float16)],
    lambda: _qkv_views(),
    # size-1 dimensions: their strides move no address and are not checked
    lambda: [torch.zeros(1, 1, 1, 20, dtype=torch.bfloat16)],
    lambda: [torch.zeros(4096, dtype=torch.bfloat16).as_strided((2, 1, 4, 64),
                                                                (512, 3, 64, 1))],
])
def test_aligned_operands_pass(make):
    flash.check_tma_alignment("flash_forward", *make())


@pytest.mark.parametrize("make, what", [
    # base 2 bytes past an aligned address
    (lambda: torch.zeros(2, 3, 10, 66, dtype=torch.bfloat16)[..., 1:65], "base address"),
    # a sequence stride of 40 bytes
    (lambda: torch.zeros(2, 3, 10, 20, dtype=torch.bfloat16), "stride 40 B along dim 2"),
    # a head stride of 8 bytes in the model's layout with D = 4
    (lambda: _qkv_views(d=4)[0], "stride 8 B along dim 1"),
])
def test_misaligned_operands_raise(make, what):
    with pytest.raises(ValueError, match="16-byte aligned") as info:
        flash.check_tma_alignment("flash_dkv", make())
    assert what in str(info.value)
    assert "flash_dkv" in str(info.value)


def test_variants_are_named_by_kind():
    """The wrapper asks the library for a variant by these kind codes, the
    order of ``Kind`` in csrc/flash.cu."""
    assert flash._KIND_CODES == {"forward": 0, "dq": 1, "dkv": 2}
    text = (PACKAGE / "ops" / "csrc" / "flash.cu").read_text()
    assert "enum Kind { kForward = 0, kDq = 1, kDkv = 2 };" in text
    for name in ("wgmma_tma_d64", "wgmma_tma_d128", "cuda_core_d64", "cuda_core_d128"):
        assert f'"{name}"' in text
