from repro_torch.core.summary import Summary
from repro_torch.core.slugger import summarize, SluggerState
from repro_torch.core.engine import SummarizerEngine
from repro_torch.core import baselines, encode_dp, minhash, pruning

__all__ = ["Summary", "summarize", "SluggerState", "SummarizerEngine",
           "baselines", "encode_dp", "minhash", "pruning"]
