from .pfchunk import (  # noqa: F401
    PfChunkReader,
    build_library,
    convert_torch_chunk,
    write_pfchunk,
)
