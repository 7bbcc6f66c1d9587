"""tetraear-tpu: TETRA IQ-processing framework on JAX accelerators.

Lazy top-level re-exports (the reference package uses the same pattern to
avoid heavy imports at package-import time, tetraear/__init__.py:25-47 —
here it keeps ``import tetraear_tpu`` from pulling in JAX).
"""

__version__ = "0.5.0"

_EXPORTS = {
    "Pipeline": ("tetraear_tpu.api", "Pipeline"),
    "PipelineConfig": ("tetraear_tpu.api", "PipelineConfig"),
    "CarrierBankDemod": ("tetraear_tpu.dsp.pipeline", "CarrierBankDemod"),
    "TetraDecoder": ("tetraear_tpu.frame.decoder", "TetraDecoder"),
    "TetraSignalValidator": ("tetraear_tpu.frame.validator",
                             "TetraSignalValidator"),
    "TEADecryptor": ("tetraear_tpu.crypto.tea", "TEADecryptor"),
    "TetraKeyManager": ("tetraear_tpu.crypto.tea", "TetraKeyManager"),
    "VoiceProcessor": ("tetraear_tpu.voice.codec", "VoiceProcessor"),
    "open_source": ("tetraear_tpu.runtime.sources", "open_source"),
    "FileIQSource": ("tetraear_tpu.runtime.sources", "FileIQSource"),
    "SyntheticTetraSource": ("tetraear_tpu.runtime.sources",
                             "SyntheticTetraSource"),
    "FrequencyScanner": ("tetraear_tpu.scan.scanner", "FrequencyScanner"),
    "WidebandScanner": ("tetraear_tpu.scan.scanner", "WidebandScanner"),
    "CallAggregator": ("tetraear_tpu.frame.aggregator", "CallAggregator"),
    "FrameStructureTracker": ("tetraear_tpu.frame.structure",
                              "FrameStructureTracker"),
    "ShardedDemod": ("tetraear_tpu.runtime.sharding", "ShardedDemod"),
    "ShardedFFTDemod": ("tetraear_tpu.runtime.sharding",
                        "ShardedFFTDemod"),
    "make_mesh": ("tetraear_tpu.runtime.sharding", "make_mesh"),
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'tetraear_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(_EXPORTS) + ["__version__"])
