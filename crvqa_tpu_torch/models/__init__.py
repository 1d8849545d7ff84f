"""Models of the port (counterpart of `crvqa_tpu/models`)."""
from .lxmert import LxmertConfig, LxmertForVQA, build_lxmert

__all__ = ["LxmertConfig", "LxmertForVQA", "build_lxmert"]
