"""Prompt templates (a copy of the JAX package's ``models/templates.py``, cut
to the text prompts of this slice's families; image slots come with the
image-query slice).

Every family prompts the MLLM to summarize the sentence "in one word",
wrapped in its chat format, and reads representations at the next-token
position. The ``<sent>`` slot is substituted at encode time.
"""

from __future__ import annotations

from dataclasses import dataclass

TEXT_SLOT = "<sent>"

_SUMMARY_TEXT = "\nSummary above sentence in one word: "
_SUMMARY_TEXT_OPEN = "\nSummary above sentence: "


@dataclass(frozen=True)
class PromptTemplate:
    """A prompt wrapper with a ``{}`` hole for the user content."""

    wrapper: str

    def text_prompt(self, one_word: bool = True) -> str:
        body = TEXT_SLOT + (_SUMMARY_TEXT if one_word else _SUMMARY_TEXT_OPEN)
        return self.wrapper.format(body)

    def fill_text(self, prompt: str, sentence: str) -> str:
        return prompt.replace(TEXT_SLOT, sentence)


# Llama-3 chat wrapper (LLaVA-NeXT-Llama3-8B, E5-V), ending with the
# assistant turn open + a space+newline so the next token is the summary word.
LLAMA3 = PromptTemplate(
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n \n")

# Self-contained wrapper for the tiny debug family (WordPieceLite tokenizer —
# plain text, no chat specials; tokens need whitespace separation).
TINY = PromptTemplate("user: {}\nassistant: ")
