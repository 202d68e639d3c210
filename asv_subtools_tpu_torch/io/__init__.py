from .kaldi import ArkScpWriter, write_vec_flt
from .wav import read_wav

__all__ = ["ArkScpWriter", "read_wav", "write_vec_flt"]
