"""Text utilities: CJK-aware word extraction and field cleaners.

Reference parity: ``closures/StringFunctions.scala`` and the cleaning UDFs in
``closures/UDFs.scala:32-78``.

Host code, copied from ``albedo_tpu/text/__init__.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from albedo_tpu_torch.text.strings import (
    clean_company,
    clean_location,
    extract_email_domain,
    extract_words,
    extract_words_include_cjk,
)

__all__ = [
    "clean_company",
    "clean_location",
    "extract_email_domain",
    "extract_words",
    "extract_words_include_cjk",
]
