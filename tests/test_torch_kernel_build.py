"""``repro_torch.kernels.build``: a library's name hashes its source, the
local headers the source reaches and the flags, so editing a shared
header such as ``csrc/sm90.cuh`` rebuilds every kernel that includes it.
Pure path arithmetic: nothing is compiled."""

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa


def test_library_path_follows_included_headers(tmp_path):
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    top = tmp_path / "inc" / "top.cuh"
    deep = tmp_path / "inc" / "deep.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/top.cuh"\n')
    top.write_text('#pragma once\n  #  include "deep.cuh"\n')
    deep.write_text("// v1\n")
    assert build.local_includes(src) == [top.resolve(), deep.resolve()]
    first = build.library_path(src)
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert build.library_path(src) == first          # stable
    deep.write_text("// v2\n")                       # a header two levels in
    second = build.library_path(src)
    assert second != first
    top.write_text('#pragma once\n#include "deep.cuh"\n// edited\n')
    assert build.library_path(src) not in (first, second)


def test_flash_source_hashes_the_sm90_header():
    heads = [p.name for p in build.local_includes(fa.SOURCE)]
    assert heads == ["sm90.cuh"]
    assert build.local_includes(pa.SOURCE) == []
