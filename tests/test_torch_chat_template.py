"""The port's chat-template interpreter against jinja2 (the JAX package's
``PromptFormatter``).

``dynamo_tpu_torch.llm.preprocessor.PromptFormatter`` (``llm/chat_template
.py``, no jinja2) and the JAX ``PromptFormatter`` (``jinja2.Environment(
keep_trailing_newline=True)``) render byte-equal text, or both raise (the
same ``ValueError`` text from ``raise_exception``), on:

- ``DEFAULT_CHAT_TEMPLATE``, the custom template of
  ``tests/test_preprocess_backend.py``, and templates in the shape of
  Llama-3.x's (``chip_smoke.LLAMA3_CHAT_TEMPLATE``), Qwen2.5's ChatML and
  Mistral v0.3's ``[INST]`` (each model's ``tokenizer_config.json`` on the
  Hugging Face Hub), over fixed conversations and hypothesis message lists
  (a system turn or not, user, assistant, tool and ipython turns, tool
  calls, ``None`` and non-string content, tools, ``date_string``);
- small templates, one construct each: whitespace control, loops and
  ``loop``, scoping, ``namespace``, tests, filters, ``tojson``'s escaping
  (and the ``Markup`` it returns escaping what is added to it), slices,
  string methods, ``range``, the inline ``if``, undefined values.

Every unsupported tag, filter, test or syntax raises when the template is
constructed, naming itself.
"""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dynamo_tpu.llm.preprocessor import DEFAULT_CHAT_TEMPLATE as JAX_DEFAULT
from dynamo_tpu.llm.preprocessor import PromptFormatter as JaxFormatter
from dynamo_tpu_torch.llm.chat_template import Template, TemplateSyntaxError
from dynamo_tpu_torch.llm.preprocessor import DEFAULT_CHAT_TEMPLATE, PromptFormatter

# In the shape of Qwen2.5 Instruct's ChatML template (the ``chat_template``
# of Qwen/Qwen2.5-7B-Instruct's tokenizer_config.json on the Hugging Face Hub).
CHATML = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\nYou may call one or more functions to assist with the user query.\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

# In the shape of Mistral Instruct v0.3's ``[INST]`` template (the
# ``chat_template`` of mistralai/Mistral-7B-Instruct-v0.3's
# tokenizer_config.json on the Hugging Face Hub).
MISTRAL = """{%- if messages[0]["role"] == "system" %}
    {%- set system_message = messages[0]["content"] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}
{%- set user_messages = loop_messages | selectattr("role", "equalto", "user") | list %}

{#- This block checks for alternating user/assistant messages, skipping tool calling messages #}
{%- set ns = namespace() %}
{%- set ns.index = 0 %}
{%- for message in loop_messages %}
    {%- if not (message.role == "tool" or message.role == "tool_results" or (message.tool_calls is defined and message.tool_calls is not none)) %}
        {%- if (message["role"] == "user") != (ns.index % 2 == 0) %}
            {{- raise_exception("After the optional system message, conversation roles must alternate user/assistant/user/assistant/...") }}
        {%- endif %}
        {%- set ns.index = ns.index + 1 %}
    {%- endif %}
{%- endfor %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if message["role"] == "user" %}
        {%- if tools is not none and (message == user_messages[-1]) %}
            {{- "[AVAILABLE_TOOLS] [" }}
            {%- for tool in tools %}
                {%- set tool = tool.function %}
                {{- '{"type": "function", "function": {' }}
                {%- for key, val in tool.items() if key != "return" %}
                    {%- if val is string %}
                        {{- '"' + key + '": "' + val + '"' }}
                    {%- else %}
                        {{- '"' + key + '": ' + val|tojson }}
                    {%- endif %}
                    {%- if not loop.last %}
                        {{- ", " }}
                    {%- endif %}
                {%- endfor %}
                {{- "}}" }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- else %}
                    {{- "]" }}
                {%- endif %}
            {%- endfor %}
            {{- "[/AVAILABLE_TOOLS]" }}
            {%- endif %}
        {%- if loop.last and system_message is defined %}
            {{- "[INST] " + system_message + "\\n\\n" + message["content"] + "[/INST]" }}
        {%- else %}
            {{- "[INST] " + message["content"] + "[/INST]" }}
        {%- endif %}
    {%- elif message.tool_calls is defined and message.tool_calls is not none %}
        {{- "[TOOL_CALLS] [" }}
        {%- for tool_call in message.tool_calls %}
            {%- set out = tool_call.function|tojson %}
            {{- out[:-1] }}
            {%- if not tool_call.id is defined or tool_call.id|length != 9 %}
                {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
            {%- endif %}
            {{- ', "id": "' + tool_call.id + '"}' }}
            {%- if not loop.last %}
                {{- ", " }}
            {%- else %}
                {{- "]" + eos_token }}
            {%- endif %}
        {%- endfor %}
    {%- elif message["role"] == "assistant" %}
        {{- " " + message["content"]|trim + eos_token}}
    {%- elif message["role"] == "tool_results" or message["role"] == "tool" %}
        {%- if message.content is defined and message.content.content is defined %}
            {%- set content = message.content.content %}
        {%- else %}
            {%- set content = message.content %}
        {%- endif %}
        {{- '[TOOL_RESULTS] {"content": ' + content|string + ", " }}
        {%- if not message.tool_call_id is defined or message.tool_call_id|length != 9 %}
            {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
        {%- endif %}
        {{- '"call_id": "' + message.tool_call_id + '"}[/TOOL_RESULTS]' }}
    {%- else %}
        {{- raise_exception("Only user and assistant roles are supported, with the exception of an initial optional system message!") }}
    {%- endif %}
{%- endfor %}
"""

# tests/test_preprocess_backend.py's custom template.
CUSTOM = "{% for m in messages %}[{{m.role}}]{{m.content}}{% endfor %}"
TEMPLATES = {"default": None, "custom": CUSTOM, "llama3": chip_smoke.LLAMA3_CHAT_TEMPLATE, "chatml": CHATML,
             "mistral": MISTRAL}
TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "Weather <in> a 'city' & more",
                                           "parameters": {"type": "object", "properties": {
                                               "city": {"type": "string"}, "days": {"type": "integer"}}},
                                           "return": {"type": "string"}}}]
CALL = {"id": "abcdefghi", "type": "function",
        "function": {"name": "get_weather", "arguments": {"days": 3, "city": "Paris <&>"}}}
CONVERSATIONS = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "  Be brief.  "}, {"role": "user", "content": "héllo\nthere"},
     {"role": "assistant", "content": " Sure. "}, {"role": "user", "content": "again"}],
    [{"role": "user", "content": "weather?"}, {"role": "assistant", "content": None, "tool_calls": [CALL]},
     {"role": "tool", "content": "{\"t\": 21}", "tool_call_id": "abcdefghi"}],
    [{"role": "system", "content": "s"}, {"role": "user", "content": "a"}, {"role": "user", "content": "b"}],
    [],
]
SETTINGS = settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))
    except Exception as e:  # noqa: BLE001 — the other error classes only need to agree by name
        return ("error", type(e).__name__)


def both(template, messages, add_generation_prompt=True, bos="<s>", eos="</s>", **extra):
    mine, theirs = PromptFormatter(template, bos, eos), JaxFormatter(template, bos, eos)
    return (outcome(lambda: mine.render(messages, add_generation_prompt, **extra)),
            outcome(lambda: theirs.render(messages, add_generation_prompt, **extra)))


def test_default_template_is_jax_s():
    assert DEFAULT_CHAT_TEMPLATE == JAX_DEFAULT
    got, want = both(None, CONVERSATIONS[1])
    assert got == want and got[1].endswith("<|assistant|>\n")


@pytest.mark.parametrize("name", list(TEMPLATES))
@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
@pytest.mark.parametrize("extra", [{}, {"tools": TOOLS}, {"date_string": "01 Jan 2025", "tools_in_user_message": False,
                                                          "tools": TOOLS}])
def test_templates_match_jinja2(name, conv, extra):
    for agp in (True, False):
        got, want = both(TEMPLATES[name], CONVERSATIONS[conv], agp, **extra)
        assert got == want


CONTENT = st.one_of(st.none(), st.text(max_size=12), st.sampled_from(["  pad  ", "<b>&'\"", "line\nline", ""]),
                    st.just({"a": [1, "<"]}), st.just(["x"]), st.integers(-3, 3))
MESSAGE = st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant", "tool", "ipython"])},
    optional={"content": CONTENT, "tool_calls": st.lists(st.just(CALL), min_size=1, max_size=2),
              "tool_call_id": st.sampled_from(["abcdefghi", "short"])})


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_templates_match_jinja2_on_generated_messages(name):
    @SETTINGS
    @given(st.lists(MESSAGE, max_size=6), st.booleans(), st.sampled_from([{}, {"tools": TOOLS}]))
    def check(messages, agp, extra):
        got, want = both(TEMPLATES[name], messages, agp, **extra)
        assert got == want

    check()


def test_raise_exception_text_matches():
    got, want = both(MISTRAL, [{"role": "assistant", "content": "x"}])
    assert got == want == ("ValueError", "After the optional system message, conversation roles must alternate "
                                         "user/assistant/user/assistant/...")
    got, want = both(chip_smoke.LLAMA3_CHAT_TEMPLATE, [{"role": "system", "content": "s"}], tools=TOOLS)
    assert got == want and got[0] == "ValueError" and "no first user message" in got[1]


CONSTRUCTS = [
    "a  {%- if true %} b {% endif -%}  c\n  {{- x -}}  d {# note #} e {#- gone -#} f",
    "{% for i in items %}{{ loop.index }}/{{ loop.index0 }}/{{ loop.length }}/{{ loop.first }}/{{ loop.last }}/"
    "{{ loop.revindex }}/{{ loop.revindex0 }},{% endfor %}",
    "{% for a in items %}{% for b in items %}{{ loop.index }}{% endfor %}{{ loop.index }};{% endfor %}",
    "{% for i in items if i > 1 %}{{ i }}{{ loop.length }}{% else %}none{% endfor %}{% for i in [] %}x{% else %}E{% endfor %}",
    "{% for k, v in pairs %}{{ k }}={{ v }};{% endfor %}{% for k in mapping %}{{ k }}{% endfor %}"
    "{% for k, v in mapping.items() %}{{ k }}{{ v }}{% endfor %}",
    "{% for i in items %}{% if i == 2 %}[{{ y }}]{% endif %}{% set y = i %}{% endfor %}<{{ y }}>",
    "{% set x = 0 %}{% for i in items %}{% set x = x + i %}{{ x }}{% endfor %}<{{ x }}>{% if true %}{% set z = 5 %}{% endif %}{{ z }}",
    "{% set a, b = 1, 2 %}{{ a }}{{ b }}{% set ns = namespace(total=0) %}{% for i in items %}"
    "{% set ns.total = ns.total + i %}{% endfor %}{{ ns.total }}",
    "{{ x is defined }}{{ undefined_name is defined }}{{ undefined_name is undefined }}{{ none is none }}"
    "{{ 'a' is string }}{{ mapping is mapping }}{{ 'a' is iterable }}{{ 3 is number }}{{ true is boolean }}"
    "{{ true is true }}{{ 0 is false }}{{ 1 is eq 1 }}{{ 1 is equalto(2) }}{{ 1 is ne 2 }}{{ 2 is in items }}"
    "{{ x is not none }}{{ items is sequence }}",
    "{{ '  a  '|trim }}|{{ items|length }}|{{ u|default('d') }}|{{ ''|default('e', true) }}|{{ ''|d('f', true) }}|"
    "{{ items|join('-') }}|{{ dicts|join(',', attribute='role') }}|{{ 'Ab'|upper }}{{ 'Ab'|lower }}|"
    "{{ items|list }}|{{ 5|string }}",
    "{{ mapping|tojson }}|{{ mapping|tojson(indent=2) }}|{{ 'x<' + (mapping|tojson) + \"'y\" }}|"
    "{{ (mapping|tojson) ~ '<' }}|{{ (mapping|tojson)|trim + '&' }}|{{ (mapping|tojson)[:-1] }}",
    "{{ dicts|selectattr('role', 'equalto', 'user')|list }}|{{ dicts|rejectattr('role', 'eq', 'user')|list }}|"
    "{{ dicts|selectattr('missing')|list }}|{{ dicts|selectattr('role', '==', 'assistant')|list|length }}",
    "{{ items[1:] }}{{ items[:-1] }}{{ items[::2] }}{{ items[-1] }}{{ 'hello'[1:3] }}{{ mapping['k'] }}{{ mapping.k }}"
    "{{ items.0 }}{{ dicts[0].role }}{{ dicts[5] }}",
    "{{ ' x '.strip() }}{{ 'abc'.startswith('a') }}{{ 'abc'.endswith('c') }}{{ 'a b'.split() }}{{ 'a,b'.split(',')[1] }}"
    "{{ mapping.get('k') }}{{ mapping.get('nope', 'dflt') }}",
    "{{ 'a' if x else 'b' }}{{ 'c' if not x }}|{{ x and 'y' }}{{ none or 'z' }}{{ 1 < 2 < 3 }}{{ 2 in items }}"
    "{{ 5 not in items }}{{ not x }}|{{ 7 // 2 }}{{ 7 % 3 }}{{ 2 ** 3 }}{{ 7 / 2 }}{{ 1 + 2 * 3 - -1 }}{{ 'a' ~ 1 ~ none }}",
    "{{ none }}|{{ true }}|{{ 1.50 }}|{{ [1, 'a'] }}|{{ {'a': 1} }}|{{ (1, 2) }}|{{ 'ab\\n\\u00e9\\x41' }}|{{ 'a' 'b' }}",
    "{{ undefined_name }}|{{ undefined_name|length }}|{% for i in undefined_name %}x{% endfor %}|"
    "{{ mapping.nope }}|{{ undefined_name ~ 'x' }}|{{ undefined_name == undefined_name }}",
    "{{ undefined_name + 'x' }}",
    "{{ undefined_name.attr }}",
    "{{ 'a' + none }}",
    "{{ x.y.z }}",
    "{{ range(3) }}",
    "line\r\nnext\rlast{{ 'in\r\nstring' }}",
    "{%+ if true %} kept {% endif %}{{- ' trimmed' }}",
]


@pytest.mark.parametrize("source", CONSTRUCTS, ids=[f"construct{i}" for i in range(len(CONSTRUCTS))])
def test_constructs_match_jinja2(source):
    import jinja2

    env = jinja2.Environment(keep_trailing_newline=True)
    values = {"x": 1, "items": [1, 2, 3], "pairs": [("a", 1), ("b", 2)], "mapping": {"k": "v<", "b": 2},
              "dicts": [{"role": "user"}, {"role": "assistant"}], "u": None}
    got = outcome(lambda: Template(source).render(**values))
    want = outcome(lambda: env.from_string(source).render(**values))
    assert got == want


UNSUPPORTED = [
    ("{% macro m() %}x{% endmacro %}", "macro"),
    ("{% call m() %}x{% endcall %}", "call"),
    ("{% include 'other' %}", "include"),
    ("{% raw %}x{% endraw %}", "raw"),
    ("{% set x %}block{% endset %}", "block {% set %}"),
    ("{% for i in items recursive %}{% endfor %}", "recursive"),
    ("{{ x|wordwrap }}", "filter 'wordwrap'"),
    ("{{ x|first }}", "filter 'first'"),
    ("{{ x is escaped }}", "test 'escaped'"),
    ("{{ x is odd }}", "test 'odd'"),
    ("{% for i in x %}{{ loop.cycle('a', 'b') }}{% endfor %}", "loop attribute 'cycle'"),
    ("{{ cycler('a') }}", "global 'cycler'"),
    ("{% frobnicate %}", "frobnicate"),
    ("{{ f(*args) }}", r"\*args"),
    ("{% if x %}unclosed", "unclosed"),
    ("{{ x", "unclosed tag"),
]


@pytest.mark.parametrize("source,match", UNSUPPORTED, ids=[u[1] for u in UNSUPPORTED])
def test_unsupported_constructs_raise_at_construction(source, match):
    with pytest.raises(TemplateSyntaxError, match=match):
        Template(source)
    with pytest.raises(ValueError):
        PromptFormatter(source)
