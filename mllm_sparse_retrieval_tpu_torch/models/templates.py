"""Prompt templates (a copy of the JAX package's ``models/templates.py``, cut
to the string-wrapper families the port builds: Llama-3 and LLaVA-1.5).

Every family prompts the MLLM to summarize the sentence or image "in one
word", wrapped in its chat format, and reads representations at the
next-token position. The ``<sent>`` slot is substituted, and the ``<image>``
slot expanded to one placeholder token per image embedding, at encode time.
"""

from __future__ import annotations

from dataclasses import dataclass

IMAGE_SLOT = "<image>"
TEXT_SLOT = "<sent>"

_SUMMARY_IMG = "\nSummary above image in one word: "
_SUMMARY_TEXT = "\nSummary above sentence in one word: "
_SUMMARY_IMG_OPEN = "\nSummary above image: "
_SUMMARY_TEXT_OPEN = "\nSummary above sentence: "


@dataclass(frozen=True)
class PromptTemplate:
    """A prompt wrapper with a ``{}`` hole for the user content.

    ``image_sep`` joins the ``<image>`` placeholders that the single
    ``<image>`` slot expands to, one per image embedding.
    """

    wrapper: str
    image_sep: str = ""

    def image_prompt(self, one_word: bool = True) -> str:
        body = IMAGE_SLOT + (_SUMMARY_IMG if one_word else _SUMMARY_IMG_OPEN)
        return self.wrapper.format(body)

    def text_prompt(self, one_word: bool = True) -> str:
        body = TEXT_SLOT + (_SUMMARY_TEXT if one_word else _SUMMARY_TEXT_OPEN)
        return self.wrapper.format(body)

    def fill_text(self, prompt: str, sentence: str) -> str:
        return prompt.replace(TEXT_SLOT, sentence)

    def expand_image(self, prompt: str, n_tokens: int) -> str:
        """Replace the ``<image>`` slot with n image-placeholder tokens."""
        return prompt.replace(
            IMAGE_SLOT, self.image_sep.join([IMAGE_SLOT] * n_tokens), 1)


# Llama-3 chat wrapper (LLaVA-NeXT-Llama3-8B, E5-V), ending with the
# assistant turn open + a space+newline so the next token is the summary word.
LLAMA3 = PromptTemplate(
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n \n")

# Vicuna-ish wrapper for LLaVA-1.5 / 1.6-Vicuna ("no_special" variant).
LLAVA_V1_5 = PromptTemplate("<s>user\n\n{}</s><s>assistant\n\n \n")

# Self-contained wrapper for the tiny debug family (WordPieceLite tokenizer —
# plain text, no chat specials; tokens need whitespace separation).
TINY = PromptTemplate("user: {}\nassistant: ", image_sep=" ")
