"""Guided decoding: grammar-constrained structured outputs.

The subsystem compiles a constraint spec (JSON Schema subset, raw regex, or
a literal choice list) into a character-level DFA (:mod:`grammar`), lifts it
to a token-level FSM against the served tokenizer's vocabulary
(:mod:`fsm` — per-state allowed-token bitmasks + a dense next-state table),
and applies it on the device through a mask pool (:mod:`processor` +
engine/sampling.py): per-step rows sample through the masked sampler, and a
fused decode window masks and advances guided rows inside its one launch.
"""

from dynamo_tpu_torch.llm.guided.grammar import (  # noqa: F401
    CharDFA,
    GrammarError,
    build_guided_spec,
    compile_regex,
    json_object_regex,
    schema_to_regex,
    spec_to_dfa,
)
from dynamo_tpu_torch.llm.guided.fsm import TokenFSM, compile_token_fsm  # noqa: F401
from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder, GuidedState  # noqa: F401
