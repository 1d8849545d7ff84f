"""Models of the port (counterpart of `crvqa_tpu/models`)."""
from .classifier import FCNet, GTH, SimpleClassifier
from .lxmert import LxmertConfig, LxmertForVQA, build_lxmert
from .visualbert import VisualBertConfig, VisualBertForVQA, build_visualbert

__all__ = ["FCNet", "GTH", "SimpleClassifier",
           "LxmertConfig", "LxmertForVQA", "build_lxmert",
           "VisualBertConfig", "VisualBertForVQA", "build_visualbert"]
