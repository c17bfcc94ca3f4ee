from kss_icp.utils.profiling import StageTimer, trace_annotation
from kss_icp.utils.log import JsonlLogger, get_logger
from kss_icp.utils.cache import ArrayCache, content_key

__all__ = [
    "StageTimer",
    "trace_annotation",
    "JsonlLogger",
    "get_logger",
    "ArrayCache",
    "content_key",
]
