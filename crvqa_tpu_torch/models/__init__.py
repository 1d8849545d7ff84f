"""Models of the port (counterpart of `crvqa_tpu/models`)."""
from .lxmert import LxmertConfig, LxmertForVQA, build_lxmert
from .visualbert import VisualBertConfig, VisualBertForVQA, build_visualbert

__all__ = ["LxmertConfig", "LxmertForVQA", "build_lxmert",
           "VisualBertConfig", "VisualBertForVQA", "build_visualbert"]
