from .llm import (LLMShape, gpt_layer_graph, gpt_workload, decode_layer_graph,
                  GPT3_175B, GPT3_1T, GPT_100T, LLAMA3_8B, LLAMA3_70B,
                  LLAMA3_405B, LLAMA_68M)
from .dlrm import dlrm_workload
from .hpl import hpl_workload
from .fft import fft_workload
from .scenarios import SCENARIOS, Scenario, get_scenario, scenario_names

__all__ = [
    "SCENARIOS", "Scenario", "get_scenario", "scenario_names",
    "LLMShape", "gpt_layer_graph", "gpt_workload", "decode_layer_graph",
    "GPT3_175B", "GPT3_1T", "GPT_100T", "LLAMA3_8B", "LLAMA3_70B",
    "LLAMA3_405B", "LLAMA_68M",
    "dlrm_workload", "hpl_workload", "fft_workload",
]
