from boxfusion_tpu_torch.native.loader import (
    NativeLoader,
    Prefetcher,
    build_error,
    get_loader,
    native_available,
)

__all__ = ["NativeLoader", "Prefetcher", "build_error", "get_loader", "native_available"]
